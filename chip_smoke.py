#!/usr/bin/env python3
"""GPU smoke test of the aligner's device path.

    python chip_smoke.py            # phases 1-4 on one GPU
    python chip_smoke.py --four     # only the four-GPU mesh phase

Phases, in the order they run (each a function that takes its sizes, so
the CPU tests can run it at a tiny size):

  1. environment: device, JAX version, compile-cache directory, the native
     engine built on this host (required: no pure-Python fallback);
  3. SE end to end through basal_jax.cli.main on a 200 Mbp repeat-rich
     reference and 500,000 100 bp -M A:G reads: device-forced,
     host-forced and auto placement, SAM bodies byte-identical;
  4. PE (100,000 pairs, 150 bp -M C:T) and gapped (GAP_READS reads,
     -M T:- -n 1 -g 3 -R -u) on the same reference, device-forced vs
     host-forced SAM byte for byte.  The gapped size is set by time, not
     memory: on this reference every gapped read needs ~125k evaluated
     candidates in either placement (PERF.md);
  2. kernels at production shapes (C = 2^20 candidates, U = 8192 active
     rows, 50 Mbp reference; W = 7 and 10): every device kernel entry
     against the native host evaluator, exact equality, with each jitted
     entry's memory analysis and its median time over 20 runs; then one
     gapped W = 16 (250 bp) wave of two memory-derived dispatch chunks;
  5. (--four only) the phase-3 data over four GPUs: automatic mesh,
     BASAL_MESH=2x2 and BASAL_MESH=0 (one card), plus a gapped run
     (FOUR_GAP_READS reads) under the same three settings, all
     byte-identical.

Everything runs in this one process (a JAX process reserves most of a
card's memory, so a second one could not use the card); only nvidia-smi
runs as a child.  Exits non-zero, printing no result line, unless jax's
first device is a GPU.  Every line carries the card's name and power
limit; the last line of standard output is the result:
    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

CARD = "card not queried"
# Sizes of the run.  Gapped reads on this reference need ~125k evaluated
# candidates each in either placement, and the device-forced gapped ladder
# runs ~18 reads/s on one H100 at 700 W (PERF.md): 100,000 reads would take
# ~1.5 h.  GAP_READS and FOUR_GAP_READS are the sizes measured to fit the
# one-card run (~400 s) and the four-card phase's three settings.
GENOME_BP = 200_000_000
SE_READS = 500_000
PE_PAIRS = 100_000
GAP_READS = 3_000
FOUR_GAP_READS = 500
NT = np.frombuffer(b"ACGT", np.uint8)
COMP = np.zeros(256, np.uint8)
COMP[list(b"ACGTN")] = list(b"TGCAN")


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg} | {CARD}", flush=True)


def query_cards() -> list:
    """`name, power.limit` per GPU, as nvidia-smi reports them."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60)
    except (OSError, subprocess.SubprocessError) as e:
        return [f"nvidia-smi unavailable ({type(e).__name__})"]
    return [l.strip() for l in r.stdout.splitlines() if l.strip()]


@contextlib.contextmanager
def env(**kv):
    """Set (value str) or unset (value None) environment variables."""
    old = {k: os.environ.get(k) for k in kv}
    try:
        for k, v in kv.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def rss_now():
    """Resident set of this process in bytes (/proc/self/statm), or None."""
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        return None


class RssPeak:
    """Peak resident set while the ``with`` block runs, sampled every 0.2 s
    on a thread (the kernel's own high-water mark spans the whole process
    and cannot be reset everywhere).  ``peak`` is None where /proc is
    unreadable."""

    def __enter__(self):
        import threading
        self.peak = rss_now()
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()
        return self

    def _run(self):
        while not self._stop.wait(0.2):
            r = rss_now()
            if r is not None:
                self.peak = max(self.peak or 0, r)

    def __exit__(self, *exc):
        self._stop.set()
        self._t.join()
        r = rss_now()
        if r is not None:
            self.peak = max(self.peak or 0, r)


def memory_line(rss_peak=None) -> str:
    """Device peak bytes in use since process start (memory_stats) and the
    host's peak resident set during the last run (``rss_peak``; the
    process's lifetime peak when None)."""
    import resource

    import jax
    stats = jax.devices()[0].memory_stats() or {}
    dev = stats.get("peak_bytes_in_use", "not reported")
    if rss_peak is None:
        life = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
        return (f"peak device memory {dev} B (process), peak host RSS "
                f"{life} B (process)")
    return (f"peak device memory {dev} B (process), peak host RSS "
            f"{rss_peak} B (this run)")


# -- data ---------------------------------------------------------------

def random_genome(rng, n: int) -> np.ndarray:
    return rng.choice(NT, size=n)


def repeat_genome(rng, n: int) -> np.ndarray:
    """bench.py's ``repeat`` profile: unique stretches of 300-1200 bp, each
    followed by 1-3 copies of one 300 bp element with 5% of sites
    re-drawn (~45% of the genome is diverged copies)."""
    alu = rng.choice(NT, size=300)
    parts, total = [], 0
    while total < n:
        u = rng.choice(NT, size=int(rng.integers(300, 1200)))
        parts.append(u)
        total += len(u)
        for _ in range(int(rng.integers(1, 4))):
            parts.append(np.where(rng.random(300) < 0.05,
                                  rng.choice(NT, size=300), alu)
                         .astype(np.uint8))
            total += 300
    return np.concatenate(parts)[:n]


def write_fasta(path: Path, g: np.ndarray, name: str = "chr1") -> None:
    n = len(g) // 60 * 60
    body = np.empty((n // 60, 61), np.uint8)
    body[:, :60] = g[:n].reshape(-1, 60)
    body[:, 60] = ord("\n")
    with open(path, "wb") as f:
        f.write(b">" + name.encode() + b"\n")
        f.write(body.tobytes())
        if n < len(g):
            f.write(g[n:].tobytes() + b"\n")


def write_fastq(path: Path, reads: np.ndarray, prefix: str = "r") -> None:
    """reads: uint8 [N, L] (one length per file)."""
    L = reads.shape[1]
    qual = b"I" * L
    with open(path, "wb") as f:
        f.write(b"".join(b"@%s%d\n%s\n+\n%s\n" % (prefix.encode(), i,
                                                  reads[i].tobytes(), qual)
                         for i in range(len(reads))))


def revcomp(a: np.ndarray) -> np.ndarray:
    return COMP[a[..., ::-1]]


def sample_windows(rng, g: np.ndarray, n: int, L: int) -> np.ndarray:
    pos = rng.integers(0, len(g) - L, n)
    return g[pos[:, None] + np.arange(L)[None, :]], pos


def convert(rng, reads: np.ndarray, frm: str, to: str, rate: float = 0.5,
            err: float = 0.005) -> np.ndarray:
    """frm -> one of ``to`` at ``rate``, then ``err`` random substitutions
    (bench.py's read model)."""
    tos = np.frombuffer(to.encode(), np.uint8)
    conv = (reads == ord(frm)) & (rng.random(reads.shape) < rate)
    out = np.where(conv, rng.choice(tos, size=reads.shape), reads)
    bad = rng.random(reads.shape) < err
    return np.where(bad, rng.choice(NT, size=reads.shape), out).astype(np.uint8)


def deletion_reads(rng, g: np.ndarray, n: int, L: int, frm: str = "T",
                   max_del: int = 3, err: float = 0.005) -> np.ndarray:
    """BID-seq style reads: a 1..max_del bp deletion at one ``frm`` base
    (away from the read ends) in every read, half reverse-complemented.
    Returns (reads uint8 [n, L], window start positions)."""
    win, pos = sample_windows(rng, g, n, L + max_del)
    site_ok = win[:, :L] == ord(frm)
    site_ok[:, :10] = False
    site_ok[:, L - 10:] = False
    score = np.where(site_ok, rng.random(site_ok.shape), -1.0)
    j = score.argmax(axis=1)
    d = rng.integers(1, max_del + 1, n)
    d = np.where(score.max(axis=1) >= 0, d, 0)  # no such base: no deletion
    cols = np.arange(L)[None, :]
    src = np.where(cols < j[:, None], cols, cols + d[:, None])
    reads = np.take_along_axis(win, src, axis=1)
    bad = rng.random(reads.shape) < err
    reads = np.where(bad, rng.choice(NT, size=reads.shape), reads)
    flip = rng.random(n) < 0.5
    reads[flip] = revcomp(reads[flip])
    return reads.astype(np.uint8), pos


def pe_reads(rng, g: np.ndarray, n: int, L: int, frm: str = "C",
             to: str = "T"):
    """Directional PE: read 1 = 5' end of a converted top-strand fragment,
    read 2 = reverse complement of its 3' end; inserts 200-400 bp."""
    ins = rng.integers(max(L, 200), 401, n)
    pos = rng.integers(0, len(g) - 400, n)
    frag = convert(rng, g[pos[:, None] + np.arange(400)[None, :]], frm, to)
    r1 = frag[:, :L]
    tail = np.take_along_axis(
        frag, (ins - L)[:, None] + np.arange(L)[None, :], axis=1)
    return r1.astype(np.uint8), revcomp(tail).astype(np.uint8)


def sam_digest(path: Path):
    """(sha256 over every line but @PG, record count); deletes the file."""
    h = hashlib.sha256()
    n = 0
    with open(path, "rb") as f:
        for line in f:
            if line.startswith(b"@PG"):
                continue
            h.update(line)
            n += not line.startswith(b"@")
    path.unlink()
    return h.hexdigest(), n


def run_cli(argv, out: Path, **envkv):
    """One in-process CLI run; returns (aligner, wall s, timings, digest,
    records).  ``timings["rss_peak"]`` is the run's peak host RSS."""
    from basal_jax import cli
    timings = {}
    with env(**envkv), RssPeak() as rss:
        t0 = time.perf_counter()
        al = cli.main([*argv, "-o", str(out)], timings=timings)
        wall = time.perf_counter() - t0
    timings["rss_peak"] = rss.peak
    digest, n = sam_digest(out)
    return al, wall, timings, digest, n


# -- phase 1 ------------------------------------------------------------

def phase_env() -> dict:
    import jax

    from basal_jax import native
    from basal_jax.compile_cache import enable_compile_cache
    d = jax.devices()[0]
    cache = enable_compile_cache()
    say("env", f"device {d.platform} {d.device_kind} x{len(jax.devices())}"
               f" | jax {jax.__version__} | compile cache {cache}")
    if not native.native_available():
        raise RuntimeError("native engine did not build on this host")
    say("env", f"native engine built on this host: {native.lib_path()}")
    return {"kind": d.device_kind, "cache": cache}


# -- phase 2 ------------------------------------------------------------

KERNEL_CASES = [  # (label, rule, nt3, gap)
    ("oneway A:G", "A:G", False, 0),
    ("multiway A:CGT", "A:CGT", False, 0),
    ("nt3 C:T", "C:T", True, 0),
    ("gapped oneway T:- g3", "T:-", False, 3),
    ("gapped multiway A:CGT g2", "A:CGT", False, 2),
]


def kernel_case(workdir: Path, rule: str, nt3: bool, gap: int, L: int,
                C: int, U: int, genome_bp: int, seed: int, cache=None):
    """(params, ref, enc, loc, plane, row): U/2 reads of length L, C/U
    candidates per active row — 16 near the read's true start on both
    planes, the rest at random reference positions.  ``cache`` (a dict the
    caller keeps) reuses the genome and the packed references."""
    from basal_jax.config import AlignParams
    from basal_jax.index.reference import load_reference
    from basal_jax.reads.encode import encode_batch
    from basal_jax.reads.io import ReadRec
    assert C % U == 0 and U % 2 == 0
    cache = {} if cache is None else cache
    p = AlignParams(conversion=rule, randseed=1, gap=gap, nt3=nt3,
                    chains=1)
    rng = np.random.default_rng(seed)
    fa = workdir / f"kernel_{genome_bp}_{seed}.fa"
    if "genome" not in cache:
        cache["genome"] = random_genome(np.random.default_rng(seed),
                                        genome_bp)
        write_fasta(fa, cache["genome"])
    g = cache["genome"]
    if rule not in cache:
        cache[rule] = load_reference(str(fa), p)
    ref = cache[rule]
    n_reads = U // 2
    frm, tos = rule.split(":")
    if gap:
        reads, pos = deletion_reads(rng, g, n_reads, L, frm=frm,
                                    max_del=gap)
    else:
        reads, pos = sample_windows(rng, g, n_reads, L)
        reads = convert(rng, reads, frm, tos)
    enc = encode_batch(p, [ReadRec(i, 0, f"k{i}", reads[i].tobytes()
                                   .decode(), "I" * L)
                           for i in range(n_reads)])
    assert enc.W == -(-L // 16)
    per = C // U
    nw = ref.ref32.shape[1]
    lo, hi = 16, 16 * (nw - enc.W - 8)
    loc = rng.integers(lo, hi, (U, per))
    plane = rng.integers(0, 2, (U, per))
    near = int(ref.ref_anchor[0]) + pos[:, None] + np.arange(-4, 4)
    near = np.clip(np.repeat(near, 2, axis=0), lo, hi - 1)   # both rows
    loc[:, :8] = near
    plane[:, :8] = 0
    loc[:, 8:16] = near
    plane[:, 8:16] = 1
    row = np.repeat(np.arange(U, dtype=np.int32), per)
    return (p, ref, enc, loc.reshape(-1).astype(np.int32),
            plane.reshape(-1).astype(np.int32), row)


def time_compiled(compiled, args, reps: int) -> float:
    """Median wall ms of ``reps`` runs, each ended by block_until_ready,
    after one warm run."""
    import jax
    jax.block_until_ready(compiled(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(compiled(*args))
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts))


def mem_line(compiled) -> str:
    m = compiled.memory_analysis()
    if m is None:
        return "memory_analysis: n/a"
    return (f"memory_analysis: args {m.argument_size_in_bytes} B, "
            f"out {m.output_size_in_bytes} B, temp {m.temp_size_in_bytes} B,"
            f" code {m.generated_code_size_in_bytes} B")


def check_exact(label, got, want_counts, want_pos0, want_pos1, C):
    counts = np.asarray(got[0] if isinstance(got, tuple) else got)[:C]
    if not np.array_equal(counts.astype(np.int32),
                          want_counts.astype(np.int32)):
        bad = int((counts.astype(np.int32) != want_counts).sum())
        raise AssertionError(f"{label}: {bad} counts differ from host twin")
    if want_pos0 is not None:
        for name, a, b in (("pos0", got[1], want_pos0),
                           ("pos1", got[2], want_pos1)):
            a = np.asarray(a)[:C].astype(np.int32)
            if not np.array_equal(a, b):
                raise AssertionError(
                    f"{label}: {int((a != b).sum())} {name} entries differ")


def phase_kernels(workdir: Path, C: int = 1 << 20, U: int = 8192,
                  genome_bp: int = 50_000_000, lengths=(100, 150),
                  reps: int = 20, seed: int = 7) -> dict:
    """Every device kernel entry at (C, U, genome_bp) against the native
    host evaluator, exact; memory analysis and median time per entry.
    Returns {entry: ms per 2^20 candidates}."""
    from basal_jax.align.pipeline import DeviceContext
    from basal_jax.native import host_eval_candidates, host_eval_candidates_gap
    out, cache = {}, {}
    for L in lengths:
        for label, rule, nt3, gap in KERNEL_CASES:
            p, ref, enc, loc, plane, row = kernel_case(
                workdir, rule, nt3, gap, L, C, U, genome_bp, seed, cache)
            if gap:
                hc, h0, h1 = host_eval_candidates_gap(p, ref, enc, loc,
                                                      plane, row)
            else:
                hc = host_eval_candidates(p, ref, enc, loc, plane, row)
                h0 = h1 = None
            hc = hc.astype(np.int32)
            fn, args, kw = DeviceContext(ref, p).wave_call(enc, loc, plane,
                                                           row)
            compiled = fn.lower(*args, **kw).compile()
            name = f"{label} W={enc.W} {fn.__name__}"
            check_exact(name, compiled(*args), hc, h0, h1, C)
            ms = time_compiled(compiled, args, reps)
            out[name] = ms * (1 << 20) / C
            say("kernels", f"{name}: exact == host twin on {C} candidates "
                           f"({int((hc <= 5).sum())} with <= 5 mismatches)"
                           f" | median {ms:.3f} ms = {out[name]:.3f} ms per"
                           f" 2^20 candidates | {mem_line(compiled)}")
    return out


def phase_long_gap(workdir: Path, C=None, U: int = 8192,
                   genome_bp: int = 50_000_000, L: int = 250,
                   seed: int = 7) -> None:
    """One gapped oneway g3 wave at W = 16 (250 bp reads) through
    DeviceContext.extend, which splits a wave into dispatch chunks sized
    from the compiled kernel's memory analysis: exact against the host
    twin over two chunks' worth of candidates (``C``, by default)."""
    from basal_jax.align.pipeline import DeviceContext
    from basal_jax.native import host_eval_candidates_gap
    cache = {}
    p, ref, enc, *_ = kernel_case(workdir, "T:-", False, 3, L, 16 * U, U,
                                  genome_bp, seed, cache)
    dc = DeviceContext(ref, p)
    chunk = dc.chunk(enc.W)
    C = C or 2 * chunk
    p, ref, enc, loc, plane, row = kernel_case(
        workdir, "T:-", False, 3, L, C, U, genome_bp, seed, cache)
    t0 = time.perf_counter()
    got = dc.extend(enc, loc, plane, row)
    wall = time.perf_counter() - t0
    hc, h0, h1 = host_eval_candidates_gap(p, ref, enc, loc, plane, row)
    check_exact(f"gapped W={enc.W}", got, hc.astype(np.int32), h0, h1, C)
    say("kernels", f"gapped oneway T:- g3 W={enc.W}: dispatch chunk {chunk}"
                   f" candidates (memory analysis vs bytes_limit); {C} "
                   f"candidates in {-(-C // chunk)} dispatches exact == host"
                   f" twin, {wall:.2f} s including compiles | "
                   f"{memory_line()}")


# -- phase 3 ------------------------------------------------------------

def make_se_data(workdir: Path, genome_bp: int, n_reads: int, seed: int):
    rng = np.random.default_rng(seed)
    g = repeat_genome(rng, genome_bp)
    ref = workdir / "ref.fa"
    write_fasta(ref, g)
    reads, _ = sample_windows(rng, g, n_reads, 100)
    fq = workdir / "se.fq"
    write_fastq(fq, convert(rng, reads, "A", "G"))
    return g, ref, fq


def stage_line(al) -> str:
    return " ".join(f"{k}={v}" for k, v in al.stage.items()
                    if k.startswith("cand_"))


def phase_se(workdir: Path, genome_bp: int = GENOME_BP,
             n_reads: int = SE_READS, seed: int = 11) -> dict:
    t0 = time.perf_counter()
    g, ref, fq = make_se_data(workdir, genome_bp, n_reads, seed)
    say("se", f"data: {genome_bp} bp repeat-rich reference, {n_reads} x "
              f"100 bp -M A:G reads (seed {seed}) made in "
              f"{time.perf_counter() - t0:.1f} s")
    argv = ["-d", str(ref), "-a", str(fq), "-M", "A:G", "-S", "1", "-V", "2"]
    res = {}
    for name, he in (("device", "0"), ("host", "1"), ("auto", None)):
        al, wall, t, digest, n = run_cli(argv, workdir / f"se_{name}.sam",
                                         BASAL_HOST_EVAL=he)
        start = t["t_ref"] + t["t_index"]
        res[name] = (digest, n, al)
        if name == "device":
            say("se", f"startup: reference load {t['t_ref']:.2f} s + index "
                      f"build {t['t_index']:.2f} s = {start:.2f} s")
        say("se", f"run {name} (BASAL_HOST_EVAL={he or 'auto'}): wall "
                  f"{wall:.2f} s, align {wall - start:.2f} s = "
                  f"{n_reads / (wall - start):.0f} reads/s after startup, "
                  f"{n_reads / wall:.0f} reads/s end to end | {n} records "
                  f"| {stage_line(al)} | {memory_line(t['rss_peak'])}")
        if name == "device":
            s = al.stage
            if not (s["cand_device"] > 0 and s["cand_host"] == 0
                    and s["cand_visit"] == 0):
                raise AssertionError(f"{name} run did not evaluate on the "
                                     f"device only: {s}")
    al = res["auto"][2]
    host, dev = al.placement_costs()
    say("se", f"auto placement: measured_placement() = "
              f"{al.measured_placement()} | measured s/candidate: host "
              f"{host if host is not None else 'not measured'}, device "
              f"{dev if dev is not None else 'not measured'}")
    digests = {k: v[0] for k, v in res.items()}
    if len(set(digests.values())) != 1:
        raise AssertionError(f"SE SAM bodies differ across placements: "
                             f"{digests}")
    say("se", f"SAM bodies byte-identical across {sorted(digests)} "
              f"({res['device'][1]} records, sha256 "
              f"{digests['device'][:16]})")
    return {"g": g, "ref": ref, "fq": fq}


# -- phase 4 ------------------------------------------------------------

def forced_pair(tag: str, argv, workdir: Path, n: int, unit: str = "reads"):
    """Device-forced vs host-forced run of one CLI configuration."""
    out = {}
    for name, he in (("device", "0"), ("host", "1")):
        al, wall, t, digest, recs = run_cli(
            argv, workdir / f"{tag}_{name}.sam", BASAL_HOST_EVAL=he)
        start = t["t_ref"] + t["t_index"]
        out[name] = (digest, recs, al)
        say(tag, f"run {name}: wall {wall:.2f} s, {n / (wall - start):.0f}"
                 f" {unit}/s after {start:.2f} s startup | {recs} records | "
                 f"{stage_line(al)} | {memory_line(t['rss_peak'])}")
    if out["device"][2].stage["cand_device"] <= 0:
        raise AssertionError(f"{tag}: device-forced run evaluated nothing "
                             f"on the device")
    if out["device"][0] != out["host"][0]:
        raise AssertionError(f"{tag}: device and host SAM bodies differ")
    say(tag, f"SAM bodies byte-identical device vs host "
             f"({out['device'][1]} records)")


def phase_pe_gap(workdir: Path, g: np.ndarray, ref: Path,
                 n_pairs: int = PE_PAIRS, n_gap: int = GAP_READS,
                 seed: int = 13) -> None:
    rng = np.random.default_rng(seed)
    r1, r2 = pe_reads(rng, g, n_pairs, 150)
    write_fastq(workdir / "pe1.fq", r1, "p")
    write_fastq(workdir / "pe2.fq", r2, "p")
    forced_pair("pe", ["-d", str(ref), "-a", str(workdir / "pe1.fq"),
                       "-b", str(workdir / "pe2.fq"), "-M", "C:T", "-S", "1",
                       "-V", "2"], workdir, n_pairs, unit="pairs")
    gfq = workdir / "gap.fq"
    write_fastq(gfq, deletion_reads(rng, g, n_gap, 100)[0])
    forced_pair("gap", ["-d", str(ref), "-a", str(gfq), "-M", "T:-", "-n",
                        "1", "-g", "3", "-R", "-u", "-S", "1", "-V", "2"],
                workdir, n_gap)


# -- phase 5 ------------------------------------------------------------

FOUR_SETTINGS = (("auto mesh", None), ("2x2", "2x2"), ("one card", "0"))


def phase_four(workdir: Path, genome_bp: int = GENOME_BP,
               n_reads: int = SE_READS, n_gap: int = FOUR_GAP_READS,
               seed: int = 11,
               settings=FOUR_SETTINGS) -> None:
    import jax
    from basal_jax.parallel.mesh import ShardedDeviceContext
    g, ref, fq = make_se_data(workdir, genome_bp, n_reads, seed)
    gfq = workdir / "gap.fq"
    write_fastq(gfq, deletion_reads(np.random.default_rng(seed + 2), g,
                                    n_gap, 100)[0])
    say("four", f"{len(jax.devices())} devices; data {genome_bp} bp, "
                f"{n_reads} SE reads, {n_gap} gapped reads")
    for tag, argv, n in (
            ("four-se", ["-d", str(ref), "-a", str(fq), "-M", "A:G", "-S",
                         "1", "-V", "2"], n_reads),
            ("four-gap", ["-d", str(ref), "-a", str(gfq), "-M", "T:-", "-n",
                          "1", "-g", "3", "-R", "-u", "-S", "1", "-V", "2"],
             n_gap)):
        digests = {}
        for name, mesh in settings:
            al, wall, t, digest, recs = run_cli(
                argv, workdir / f"{tag}.sam", BASAL_HOST_EVAL="0",
                BASAL_MESH=mesh)
            d = al.dev
            shape = (f"dp={d.n_dp} rs={d.n_rs}"
                     if isinstance(d, ShardedDeviceContext) else "1 device")
            start = t["t_ref"] + t["t_index"]
            digests[name] = digest
            say(tag, f"{name} (BASAL_MESH={mesh or 'unset'}): {shape} | "
                     f"wall {wall:.2f} s, {n / (wall - start):.0f} reads/s "
                     f"after {start:.2f} s startup | {recs} records | "
                     f"{stage_line(al)} | {memory_line(t['rss_peak'])}")
            if al.stage["cand_device"] <= 0:
                raise AssertionError(f"{tag} {name}: nothing on the device")
        if len(set(digests.values())) != 1:
            raise AssertionError(f"{tag}: SAM bodies differ: {digests}")
        say(tag, f"SAM bodies byte-identical across {list(digests)}")


# -- main ---------------------------------------------------------------

def main(argv=None) -> int:
    global CARD
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU mesh phase")
    a = ap.parse_args(argv)

    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU, jax found {devs[0].platform!r}",
              file=sys.stderr)
        return 2
    cards = query_cards()
    CARD = "; ".join(cards) if a.four else cards[0]
    failed = []

    def phase(name, fn, *args, **kw):
        try:
            return fn(*args, **kw)
        except Exception as e:  # noqa: BLE001 - reported, then exit 1
            import traceback
            traceback.print_exc()
            say(name, f"FAILED: {type(e).__name__}: {e}")
            failed.append(name)
            return None

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        work = Path(tmp)
        phase("env", phase_env)
        if failed:
            pass  # no engine or no device: nothing below can run
        elif a.four:
            phase("four", phase_four, work)
        else:
            # SE first: its peak device memory is then the SE run's own
            se = phase("se", phase_se, work)
            if se is not None:
                phase("pe+gap", phase_pe_gap, work, se["g"], se["ref"])
            phase("kernels", phase_kernels, work)
            phase("kernels", phase_long_gap, work)
    if failed:
        say("result", f"failed phases: {failed}")
        return 1
    d = jax.devices()[0]
    say("result", "all phases passed")
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
