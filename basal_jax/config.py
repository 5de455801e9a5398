"""Configuration and conversion-rule compiler for the BASAL framework.

This module is the equivalent of the reference's parameter system
(``param.h`` / ``param.cpp`` in JiejunShi/BASAL): it parses the ``-M X:Y...``
conversion rule and compiles the remapped 2-bit alphabet plus all derived
lookup tables (cf. ``param.cpp:163-263``), the seed-offset profile
(``param.cpp:70-74``), and holds every alignment flag with the reference's
defaults (``param.cpp:7-68``).

Everything here is host-side numpy; the tables feed both the host packers and
the device kernels.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

SEGLEN = 32           # bases per u64 word in the reference layout (param.h:4)
SEGLEN32 = 16         # bases per u32 word (u32 lane layout: one u64 = two u32)
FIXELEMENT = 16       # max read register file: 16 u64 words = 512bp (param.h:17)
FIXSIZE = SEGLEN * FIXELEMENT
#: Every environment setting the program reads.  cli.main refuses any
#: other BASAL_* variable (check_env), so a misspelt or retired setting
#: fails loudly instead of being silently ignored.
ENV_KNOBS = frozenset({
    "BASAL_BLOB", "BASAL_FUSED", "BASAL_FUSED_CHUNK", "BASAL_HOST_EVAL",
    "BASAL_HUGEPAGE", "BASAL_MESH", "BASAL_NO_MALLOC_TUNE",
    "BASAL_NO_NATIVE", "BASAL_NO_PREFETCH", "BASAL_NO_RAW",
    "BASAL_NO_THP_TUNE", "BASAL_PE_BULK0", "BASAL_PE_SPLIT_CANDS",
    "BASAL_PROFILE", "BASAL_RRBS_SCALAR", "BASAL_THP"})


def check_env(environ) -> None:
    """Raise ValueError listing each BASAL_* variable in ``environ`` that
    is not in ENV_KNOBS, with the setting it most likely means (the name
    with one of its words after the prefix dropped)."""
    bad = []
    for k in sorted(environ):
        if not k.startswith("BASAL_") or k in ENV_KNOBS:
            continue
        w = k.split("_")
        near = [n for n in ("_".join(w[:i] + w[i + 1:])
                            for i in range(1, len(w))) if n in ENV_KNOBS]
        bad.append(k + (f" (did you mean {near[0]}?)" if near else ""))
    if bad:
        raise ValueError("unknown environment setting " + ", ".join(bad)
                         + "; known: " + " ".join(sorted(ENV_KNOBS)))


MAXSNPS = 15          # max mismatches (param.h:18)
MAXGAPS = 3           # max gap length, one gap (param.h:19)
MAXHITS = 1000        # -DMAXHITS=1000 (makefile:4)
REF_MARGIN = 400      # u64 words of margin around the concatenated ref (refbase.h:16)
BINSEQPAD = 2         # u64 pad words per sequence (refbase.h:17)
BATCH_NUM = 50000     # reads per batch (reads.h:14)

NT_CODE = "ACGT-"
REVNT_CODE = "TGCA-"


def _lut256() -> np.ndarray:
    return np.zeros(256, dtype=np.uint8)


# Canonical 2-bit codes A=0 C=1 G=2 T=3 (param.cpp:119-128, alphabet0)
ALPHABET0 = _lut256()
for _i, _c in enumerate("ACGT"):
    ALPHABET0[ord(_c)] = _i
    ALPHABET0[ord(_c.lower())] = _i

# Valid-base table: ACGT/acgt -> 3 (=0b11), everything else 0 (param.cpp:130-139)
REG_ALPHABET = _lut256()
for _c in "ACGTacgt":
    REG_ALPHABET[ord(_c)] = 3

# Reverse-complement char table; unknown -> 'N' (param.cpp:147-156)
REV_CHAR = np.full(256, ord("N"), dtype=np.uint8)
for _a, _b in zip("ACGTacgt", "TGCAtgca"):
    REV_CHAR[ord(_a)] = ord(_b)


class ConversionRuleError(ValueError):
    pass


@dataclasses.dataclass
class ConversionRule:
    """Compiled ``-M`` conversion rule (reference Param::SetAlign, param.cpp:163-263).

    The remapped alphabet puts the convert-from base at code 01 so the XC mask
    trick works; with exactly one non-deletion convert-to base that base gets
    code 11 (legacy one-way fast path), otherwise remaining bases take codes
    {00,10,11} in order.
    """

    rule: str
    refnt: str = ""
    readnts: str = ""                       # convert-to bases (may include '-')
    bit_nt: np.ndarray = None               # base-index(ACGT) -> 2-bit code
    alphabet: np.ndarray = None             # char -> remapped code (fwd)
    rev_alphabet: np.ndarray = None         # char -> remapped code of complement
    alphabet_mread: np.ndarray = None       # char -> 01 if convert-to else 11/0
    rev_alphabet_mread: np.ndarray = None
    useful_nt: str = ""                     # code -> display char (8 chars)

    @property
    def readnt_cnt(self) -> int:
        return len(self.readnts)

    @property
    def one_way(self) -> bool:
        """True when the legacy 2-plane CountMismatch path applies
        (exactly one convert-to base and it is not '-'; align.cpp:451-455)."""
        return self.readnt_cnt == 1 and self.readnts[0] != "-"


def compile_conversion_rule(rule: str) -> ConversionRule:
    """Parse and compile ``-M`` (e.g. ``C:T``, ``A:CGT``, ``T:-``).

    Mirrors Param::SetAlign (param.cpp:163-263) including duplicate-letter
    de-dup and validation order.
    """
    if len(rule) < 3 or rule[1] != ":":
        raise ConversionRuleError(
            "invalid -M, ref base(one letter in A/C/G/T) should be assigned first before :")
    refnt = rule[0].upper()
    if refnt not in "ACGT":
        raise ConversionRuleError(f"invalid -M, ref base {rule[0]} not in A/C/G/T")
    readnts = ""
    for ch in rule[2:]:
        c = ch.upper()
        if c == refnt:
            raise ConversionRuleError(
                f"invalid -M, read base {ch} should not be equal to ref base {refnt}")
        if c not in "ACGT-":
            raise ConversionRuleError(f"invalid -M, read base {ch} not in A/C/G/T/-")
        if c not in readnts:
            readnts += c

    # --- read-mask tables (param.cpp:202-215): convert-to bases 01, other valid 11
    alphabet_mread = REG_ALPHABET.copy()
    rev_alphabet_mread = REG_ALPHABET.copy()
    for c in readnts:
        alphabet_mread[ord(c)] = 1
        alphabet_mread[ord(c.lower())] = 1
        if c != "-":
            rc = REVNT_CODE[NT_CODE.index(c)]
            rev_alphabet_mread[ord(rc)] = 1
            rev_alphabet_mread[ord(rc.lower())] = 1

    # --- remapped 2-bit codes (param.cpp:216-233)
    bit_nt = np.full(4, 100, dtype=np.int64)
    bit_nt[ALPHABET0[ord(refnt)]] = 1
    # NOTE: the reference declares an inner `int other_bit[2]` that shadows and
    # is unused (param.cpp:225); the outer {0,2,3} is always consumed in order.
    other_bits = [0, 2, 3]
    if len(readnts) == 1 and readnts[0] != "-":
        bit_nt[ALPHABET0[ord(readnts[0])]] = 3
    j = 0
    for i in range(4):
        if bit_nt[i] == 100:
            bit_nt[i] = other_bits[j]
            j += 1
    bit_nt = bit_nt.astype(np.uint8)

    # --- encode tables (param.cpp:238-257)
    alphabet = _lut256()
    rev_alphabet = _lut256()
    for i, c in enumerate("ACGT"):
        alphabet[ord(c)] = bit_nt[i]
        alphabet[ord(c.lower())] = bit_nt[i]
        rev_alphabet[ord(c)] = bit_nt[3 - i]
        rev_alphabet[ord(c.lower())] = bit_nt[3 - i]

    useful = list("ACGTacgt")
    for i in range(4):
        useful[int(bit_nt[i])] = NT_CODE[i]
        useful[int(bit_nt[i]) + 4] = NT_CODE[i].lower()

    return ConversionRule(
        rule=rule, refnt=refnt, readnts=readnts, bit_nt=bit_nt,
        alphabet=alphabet, rev_alphabet=rev_alphabet,
        alphabet_mread=alphabet_mread, rev_alphabet_mread=rev_alphabet_mread,
        useful_nt="".join(useful),
    )


@dataclasses.dataclass
class AlignParams:
    """All aligner knobs, defaults identical to the reference Param()
    constructor (param.cpp:7-68) and CLI clamping (main.cpp:272-364)."""

    conversion: str = "C:T"                 # -M (required in CLI)
    seed_size: int = 16                     # -s (10..16, param.cpp:108-115)
    index_interval: int = 4                 # -I (1..16)
    max_kmer_ratio: float = 5e-7            # -k
    max_snp_num: int = 110                  # -v encoded (>=100 => percent)
    gap: int = 0                            # -g (<= MAXGAPS)
    gap_edge: int = 6                       # fixed (param.cpp:57)
    max_num_hits: int = 100                 # -w (<= MAXHITS)
    report_repeat_hits: int = 1             # -r 0/1/2
    chains: int = 0                         # -n 0 directional /1 non-directional /2 PBAT
    randseed: int = 0                       # -S
    pairend: bool = False
    min_insert: int = 28                    # -m
    max_insert: int = 1000                  # -x
    qual_threshold: int = 0                 # -q
    zero_qual: int = ord("!")               # -z
    default_qual: int = 40
    max_ns: int = 5                         # -f
    n_mis: bool = False                     # -N count N as mismatch
    nt3: bool = False                       # -3 three-letter mode
    max_readlen: int = (FIXELEMENT - 1) * SEGLEN  # -L (480)
    read_start: int = 1                     # -B
    read_end: int = 0xFFFFFFFF              # -E
    out_ref: bool = False                   # -R
    out_unmap: bool = False                 # -u
    sam_header: bool = True                 # -H disables
    adapters: tuple = ()                    # -A (up to 10)
    num_threads: int = 1                    # -p (host-side pipeline threads)
    verbose_level: int = 1                  # -V
    batch_reads: int = BATCH_NUM
    # RRBS / digestion-site mode (hidden -D)
    digestion_site: str = ""
    rrbs_flag: bool = False
    # Length-filter threshold quirk: the reference's constructor calls
    # SetSeedSize(16) BEFORE index_interval is initialized (param.cpp:26 vs
    # :52), so with the default seed the member min_read_size ends up
    # 16 + 0 - 1 = 15; only an explicit -s recomputes it with the live
    # index_interval.  None -> emulate in __post_init__.
    min_read_size_quirk: Optional[int] = None

    _rule: Optional[ConversionRule] = None

    def __post_init__(self):
        if not (10 <= self.seed_size <= 16):
            raise ValueError("seed size must be between 10 and 16")
        if self.gap > MAXGAPS:
            self.gap = MAXGAPS
        if self.max_num_hits > MAXHITS:
            raise ValueError(f"number of multi-hits exceeds max value:{MAXHITS}")
        if self.max_snp_num > MAXSNPS and self.max_snp_num < 100:
            self.max_snp_num = MAXSNPS
        if self.digestion_site:
            self.rrbs_flag = True
            self.index_interval = 1
        if self.index_interval > 16:
            raise ValueError("index interval exceeds max value:16")
        if self.min_read_size_quirk is None:
            self.min_read_size_quirk = (15 if self.seed_size == 16
                                        else self.seed_size
                                        + self.index_interval - 1)
        if self.nt3 and self.rule.readnt_cnt > 1:
            raise ValueError(
                "3-nucleotide mapping approach is only valid for single convert-to base")

    @property
    def rule(self) -> ConversionRule:
        if self._rule is None or self._rule.rule != self.conversion:
            object.__setattr__(self, "_rule", compile_conversion_rule(self.conversion))
        return self._rule

    @property
    def seed_bits(self) -> int:
        return (1 << (2 * self.seed_size)) - 1

    @property
    def min_read_size(self) -> int:
        if self.min_read_size_quirk is not None:
            return self.min_read_size_quirk
        return self.seed_size + self.index_interval - 1

    @property
    def total_kmers(self) -> int:
        return 3 ** self.seed_size

    @property
    def max_seedseg_num(self) -> int:
        return (FIXELEMENT - 1) * SEGLEN // self.seed_size

    def profile(self) -> np.ndarray:
        """Seed probe-offset profile (Param::InitMapping, param.cpp:70-74):
        profile[j][i] = ceil((j*seed_size + i)/I)*I for i in [0, I)."""
        I = self.index_interval
        j = np.arange(MAXSNPS + 1)[:, None]
        i = np.arange(I)[None, :]
        return (((j * self.seed_size + i + I - 1) // I) * I).astype(np.int64)

    @staticmethod
    def parse_v(v: float) -> int:
        """CLI -v encoding (main.cpp:324-338)."""
        if v < 1.0:
            m = int(v * 100 + 0.5) + 100
            return 0 if m == 100 else m
        m = int(v + 0.5)
        return min(m, MAXSNPS)
