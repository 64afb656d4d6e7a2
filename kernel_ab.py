#!/usr/bin/env python3
"""A/B of the attention kernels K1-K4, K9-K11 and the ring-block kernels
K12-K14 between this checkout and another one, say the parent commit
unpacked with ``git archive`` into a gitignored directory, or a copy of
this tree with one constant changed, on one GPU:

    python3 kernel_ab.py --other _archive/parent [--pairs 20] [--calls 20]
                         [--kernels flash_ring_fwd,flash_ring_dkv]

Both checkouts' sources are compiled with this checkout's nvcc flags.
For each kernel it prints one JSON line with:

- ``ptxas``: each build's register, spill and stack report, and any
  warning that it serialised wgmma;
- ``sass``: each build's instruction count, the opcodes whose counts
  differ, and how many instruction lines differ, as printed and with
  every hex literal masked (constant-bank offsets and branch targets
  move when a kernel argument struct grows);
- ``tensor_core``: each build's count of HGMMA (wgmma), UTMALDG (TMA
  load) and HMMA (mma.sync / WMMA) instructions, the tensor-core path
  the kernel takes (HGMMA and UTMALDG for every attention kernel but
  K2, which uses no tensor cores; HMMA only where a checkout still has
  a WMMA loop);
- ``bit_equal``: whether the two builds give bit-equal outputs on the
  same inputs, and when they do not (a loop that sums in another order),
  ``diff``: per output, the largest absolute difference and that over
  the other build's largest absolute value;
- ``ms``: the time in ``--pairs`` alternating pairs (this, other; then
  other, this; ...), each side one replay of a CUDA graph that holds
  ``--calls`` calls of the wrapper, timed with CUDA events and divided
  by the count (device time: a ring block runs a few tens of
  microseconds, near the wrappers' host cost per call): each side's
  median, min and max, and the other/this ratio of each pair (median,
  min, max).

Each kernel runs at the shapes of its path, one line per ``case``:

- K1-K4 (with K1's rope pre-pass ``flash_fwd_rope_k`` on its own) and
  K9-K11 at the training slice's shape (``slice``: B8 H8 KVH8 S2048 D128,
  causal; rope in K1/K3/K4, the [B, S, H*D] layout for K9-K11);
- K1-K4 at head_dim 64: gpt2-1.5b's attention (``gpt2-d64``: B8 H25
  KVH25 S1024 D64, causal, no rope, the shape of chip_smoke.py's
  ``D64_SHAPES["gpt2"]``), the same on the layouts models/gpt2.py passes
  (``gpt2-views-d64``: q, k and v views of one [B, S, 3*H*D] projection,
  row stride 3*H*D, and do the [B, H, S, D] transpose of a [B, S, H*D]
  gradient, row stride H*D; o contiguous, as K1 writes it) and a roped
  GQA shape (``gqa-d64``: B2 H16 KVH4 S1024 D64, causal; the pre-pass
  runs here too);
- K12-K14 at the [seq4] run's block shape (B8 H8 KVH8, 512-row shards)
  for the wholly visible block (``visible``) and the diagonal one
  (``diagonal``), and at a GQA block shape (``gqa-visible``: B2 H32
  KVH8, 256-row shards), every operand the shard's view of a whole
  [B, S, heads, D] sequence as the ring receives it (the q shard of
  ring rank 1, the kv shard of rank 0 or 1), with the lse and delta of
  the ring over the two visible blocks.

K1's, K3's and K4's times include their rope pre-passes
(``flash_fwd_rope_k``: k for K1, q and k for K3 and for K4); against a
checkout whose wrapper of that kernel runs no pre-pass (its kernel ropes
inside the loop), that side runs without it.

The C entries must take the same arguments in both checkouts, with one
exception: the entries of K1-K4 (and K1's pre-pass) that take the head
width first (head_dim 64 and 128, each its own template instantiation)
are called without it on a checkout whose entries do not take it (built
for 128 only; its ``-d64`` cases are then skipped). A case runs at
head_dim 128 unless its name ends in ``-d64``, and a templated kernel's
``ptxas`` and ``sass`` fields are those of the instantiation at the
case's width. The card's name and power limit come first; the whole
report also goes to ``chiprun_out/kernel_ab.json``.
"""

from __future__ import annotations

import argparse
import ast
import contextlib
import ctypes
import difflib
import json
import re
import shutil
import statistics
import subprocess
import sys
from collections import Counter
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out"
B, H, KVH, S, D = 8, 8, 8, 2048, 128
# K1-K4's head_dim 64 cases: (B, H, KVH, S, rope, the model's views)
D64_CASES = {"gpt2-d64": (8, 25, 25, 1024, False, False),
             "gpt2-views-d64": (8, 25, 25, 1024, False, True),
             "gqa-d64": (2, 16, 4, 1024, True, False)}
# ring blocks: case -> (B, H, KVH, shard length, kv shard's ring rank)
RING_CASES = {"visible": (8, 8, 8, 512, 0), "diagonal": (8, 8, 8, 512, 1),
              "gqa-visible": (2, 32, 8, 256, 0)}
SEQ = 4  # ring ranks of the whole sequence the shards are cut from
# library -> the C entries compared (each launches <entry>_kernel)
LIBRARIES = {
    "flash_fwd": ("flash_fwd", "flash_fwd_rope_k"),
    "flash_bwd": ("flash_bwd_preprocess", "flash_bwd_dq", "flash_bwd_dkv"),
    "flash_heads": ("flash_fwd_heads", "flash_bwd_dq_heads",
                    "flash_bwd_dkv_heads"),
    "flash_ring": ("flash_ring_fwd", "flash_ring_dq", "flash_ring_dkv"),
}
# entry -> the pre-pass its wrapper launches before it
PREPASS = {"flash_fwd": "flash_fwd_rope_k", "flash_bwd_dq": "flash_fwd_rope_k",
           "flash_bwd_dkv": "flash_fwd_rope_k"}
TENSOR_CORE = ("HGMMA", "UTMALDG", "HMMA")
INSTR = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;")
HEX = re.compile(r"0x[0-9a-f]+")


def log(msg: str) -> None:
    print(msg, flush=True)


def build_this():
    """This checkout's libraries and their ptxas reports."""
    from dlrover_tpu_torch.ops import _build

    _build.build(LIBRARIES)
    return {name: (_build.library_path(name),
                   _build.library_path(name).with_suffix(".log").read_text())
            for name in LIBRARIES}


def build_other(other: Path):
    """``other``'s libraries, compiled in parallel with this checkout's
    flags into its ``ops/build/ab-<name>.so``, and their ptxas reports."""
    from dlrover_tpu_torch.ops import _build

    out_dir = other / "dlrover_tpu_torch" / "ops" / "build"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in LIBRARIES:
        src = other / "dlrover_tpu_torch" / "ops" / "csrc" / f"{name}.cu"
        so = out_dir / f"ab-{name}.so"
        procs[name] = (so, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(so), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for name, (so, proc) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed on {other}'s {name}:\n{text}")
        built[name] = (so, text)
    return built


def width_of(case: str) -> int:
    """The head width a case runs at."""
    return 64 if case.endswith("-d64") else D


def mangled(kernel: str, width: int) -> re.Pattern:
    """The kernel's name inside its mangled symbol (``<len><name>E``, or
    ``<len><name>ILi<width>EEE`` for the instantiation at ``width`` of a
    kernel templated on the head width)."""
    return re.compile(rf"\d+{kernel}(?:ILi{width}EE)?E")


def ptxas_report(text: str, kernel: str, width: int) -> list[str]:
    """The ptxas lines of ``kernel``'s entry function, and its warnings
    (such as C7512/C7514, wgmma serialised), which come before them."""
    lines, found, pattern = text.splitlines(), [], mangled(kernel, width)
    for i, line in enumerate(lines):
        if "Potential Performance Loss" in line and pattern.search(line):
            found.append(line.replace("ptxas info    :", "").strip())
        if "Compiling entry function" in line and pattern.search(line):
            for nxt in lines[i + 1:]:
                if "Compiling entry function" in nxt:
                    break
                found.append(nxt.replace("ptxas info    :", "").strip())
    return found


def sass(so: Path, kernel: str, width: int):
    """The instruction lines of ``kernel``'s function at ``width`` in
    ``so``, or None when cuobjdump is missing."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return None
    text = subprocess.run([tool, "-sass", str(so)], check=True,
                          capture_output=True, text=True).stdout
    pattern, instrs, inside = mangled(kernel, width), [], False
    for line in text.splitlines():
        if "Function :" in line:
            inside = bool(pattern.search(line))
            continue
        match = INSTR.search(line) if inside else None
        if match:
            instrs.append(match.group(1))
    return instrs


def opcode(instr: str) -> str:
    words = instr.split()
    return words[1] if words[0].startswith("@") else words[0]


def tensor_core(instrs: list[str]) -> dict:
    counts = Counter(opcode(i).split(".")[0] for i in instrs)
    return {op: counts[op] for op in TENSOR_CORE}


def difference(this, other) -> list[dict]:
    """Per output: the largest absolute difference, and that over the
    other build's largest absolute value."""
    out = []
    for a, b in zip(this, other):
        diff = (a.float() - b.float()).abs().max().item()
        out.append({"max_abs": diff,
                    "max_rel": diff / b.float().abs().max().item()})
    return out


@contextlib.contextmanager
def without_prepass(att, entry: str):
    """Run ``entry``'s wrapper with its pre-pass as the identity (for a
    library whose kernel does that work itself)."""
    name = PREPASS[entry]
    saved = getattr(att, name)
    setattr(att, name, lambda x, *tables: x)
    try:
        yield
    finally:
        setattr(att, name, saved)


def runs_prepass(root: Path, entry: str) -> bool:
    """Whether the wrapper of ``entry`` in ``root``'s attention module
    calls the pre-pass ``PREPASS[entry]``."""
    source = root / "dlrover_tpu_torch" / "ops" / "attention.py"
    for node in ast.parse(source.read_text()).body:
        if isinstance(node, ast.FunctionDef) and node.name == entry:
            return any(isinstance(n, ast.Name) and n.id == PREPASS[entry]
                       for n in ast.walk(node))
    return False


def takes_width(root: Path, lib: str, entry: str) -> bool:
    """Whether ``root``'s C entry ``entry`` takes the head width first."""
    source = root / "dlrover_tpu_torch" / "ops" / "csrc" / f"{lib}.cu"
    return re.search(rf'extern "C" int {entry}\(int head_dim',
                     source.read_text()) is not None


def differing(a: list[str], b: list[str]) -> int:
    """Instruction lines of ``a`` and ``b`` outside their longest common
    runs."""
    matcher = difflib.SequenceMatcher(None, a, b, autojunk=False)
    same = sum(block.size for block in matcher.get_matching_blocks())
    return len(a) + len(b) - 2 * same


def compare_sass(this: list[str], other: list[str]) -> dict:
    counts = Counter(map(opcode, this)), Counter(map(opcode, other))
    masked = [[HEX.sub("0x_", i) for i in side] for side in (this, other)]
    return {
        "this_instructions": len(this), "other_instructions": len(other),
        "opcode_count_other_minus_this": {
            op: counts[1][op] - counts[0][op]
            for op in sorted(set(counts[0]) | set(counts[1]))
            if counts[1][op] != counts[0][op]},
        "differing_lines": differing(this, other),
        "differing_lines_hex_masked": differing(*masked),
    }


def ring_calls(att, gen):
    """entry -> {case: a call of its wrapper on one ring block}."""
    calls = {name: {} for name in LIBRARIES["flash_ring"]}
    scale = D ** -0.5
    for case, (b, h, kvh, s, rank) in RING_CASES.items():
        q, k, v, do = (
            torch.randn(b, SEQ * s, heads, D, generator=gen, device="cuda")
            .to(torch.bfloat16).transpose(1, 2) for heads in (h, kvh, kvh, h))
        q, do = q[:, :, s:2 * s], do[:, :, s:2 * s]
        k, v = (t[:, :, rank * s:(rank + 1) * s] for t in (k, v))
        # the ring's lse and delta over the two visible blocks of rank 1
        blocks = [att.flash_ring_fwd_plain(q, k, v, s, c * s, scale)
                  for c in (0, 1)]
        lse = torch.logaddexp(blocks[0][1], blocks[1][1])
        o = sum(o_c.float() * (lse_c - lse).exp()[..., None]
                for o_c, lse_c in blocks)
        delta = att.flash_bwd_preprocess_plain(do, o.to(torch.bfloat16))
        fwd = (q, k, v, s, rank * s, scale)
        bwd = (q, k, v, do, lse, delta, s, rank * s, scale)
        calls["flash_ring_fwd"][case] = lambda a=fwd: att.flash_ring_fwd(*a)
        calls["flash_ring_dq"][case] = lambda a=bwd: att.flash_ring_dq(*a)
        calls["flash_ring_dkv"][case] = lambda a=bwd: att.flash_ring_dkv(*a)
    return calls


def kernel_calls():
    """entry -> {case: a call of its wrapper at that case's shape}."""
    from dlrover_tpu_torch.models.llama import _rope_tables
    from dlrover_tpu_torch.ops import attention as att

    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    q, k, v, do = (randn(B, heads, S, D) for heads in (H, KVH, KVH, H))
    cos, sin = _rope_tables(torch.arange(S, device="cuda").expand(B, S),
                            D // 2, 10000.0, torch.bfloat16)
    cos, sin = torch.cat([cos, cos], -1), torch.cat([sin, sin], -1)
    scale = D ** -0.5
    o, lse = att.flash_fwd_plain(q, k, v, cos, sin, True, scale)
    delta = att.flash_bwd_preprocess_plain(do, o)
    bwd = (q, k, v, do, lse, delta, cos, sin, True, scale)
    fused = [att._merge_heads(t) for t in (q, k, v, do)]
    o_f, lse_f = att.flash_fwd_heads_plain(*fused[:3], H, True, scale)
    delta_f = att.flash_bwd_preprocess_plain(
        att._split_heads(fused[3], H), att._split_heads(o_f, H))
    bwd_f = (*fused, lse_f, delta_f, H, True, scale)
    slice_calls = {
        "flash_fwd": lambda: att.flash_fwd(q, k, v, cos, sin, True, scale),
        "flash_fwd_rope_k": lambda: att.flash_fwd_rope_k(k, cos, sin),
        "flash_bwd_preprocess": lambda: att.flash_bwd_preprocess(do, o),
        "flash_bwd_dq": lambda: att.flash_bwd_dq(*bwd),
        "flash_bwd_dkv": lambda: att.flash_bwd_dkv(*bwd),
        "flash_fwd_heads": lambda: att.flash_fwd_heads(*fused[:3], H, True,
                                                       scale),
        "flash_bwd_dq_heads": lambda: att.flash_bwd_dq_heads(*bwd_f),
        "flash_bwd_dkv_heads": lambda: att.flash_bwd_dkv_heads(*bwd_f),
    }
    calls = {name: {"slice": fn} for name, fn in slice_calls.items()}
    for case, shape in D64_CASES.items():
        for name, fn in d64_calls(att, gen, *shape).items():
            calls[name][case] = fn
    calls.update(ring_calls(att, gen))
    return calls


def d64_calls(att, gen, b, h, kvh, s, rope, views):
    """entry -> a call of its wrapper at one head_dim 64 case (K1-K4,
    causal; the pre-pass only with rope; with ``views`` q, k, v and do as
    models/gpt2.py passes them, h == kvh)."""
    from dlrover_tpu_torch.models.llama import _rope_tables

    if views:
        qkv = torch.randn(b, s, 3, h, 64, generator=gen, device="cuda").to(
            torch.bfloat16)
        q, k, v = qkv.transpose(1, 3).unbind(2)
        do = torch.randn(b, s, h, 64, generator=gen, device="cuda").to(
            torch.bfloat16).transpose(1, 2)
    else:
        q, k, v, do = (torch.randn(b, heads, s, 64, generator=gen,
                                   device="cuda").to(torch.bfloat16)
                       for heads in (h, kvh, kvh, h))
    cos = sin = None
    if rope:
        cos, sin = _rope_tables(torch.arange(s, device="cuda").expand(b, s),
                                32, 10000.0, torch.bfloat16)
        cos, sin = torch.cat([cos, cos], -1), torch.cat([sin, sin], -1)
    scale = 64 ** -0.5
    o, lse = att.flash_fwd_plain(q, k, v, cos, sin, True, scale)
    delta = att.flash_bwd_preprocess_plain(do, o)
    bwd = (q, k, v, do, lse, delta, cos, sin, True, scale)
    calls = {
        "flash_fwd": lambda: att.flash_fwd(q, k, v, cos, sin, True, scale),
        "flash_bwd_preprocess": lambda: att.flash_bwd_preprocess(do, o),
        "flash_bwd_dq": lambda: att.flash_bwd_dq(*bwd),
        "flash_bwd_dkv": lambda: att.flash_bwd_dkv(*bwd),
    }
    if rope:
        calls["flash_fwd_rope_k"] = lambda: att.flash_fwd_rope_k(k, cos, sin)
    return calls


def graph_of(fn, calls: int):
    """A CUDA graph of ``calls`` calls of fn(), captured after a warm-up
    call outside it and replayed once."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return graph


def replay_ms(graph, calls: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def spread(values) -> dict:
    return {"median": statistics.median(values), "min": min(values),
            "max": max(values)}


def compare(call, entry, fns, bare, args) -> dict:
    """Bit-equality (or the largest difference) and alternating-pair times
    of ``call`` through this checkout's entry and the other's."""
    from dlrover_tpu_torch.ops import _build
    from dlrover_tpu_torch.ops import attention as att

    def run(side):
        _build._bound[entry] = fns[side]
        if side == "other" and bare:
            with without_prepass(att, entry):
                return call()
        return call()

    outs = {side: run(side) for side in fns}
    flat = {side: out if isinstance(out, tuple) else (out,)
            for side, out in outs.items()}
    bit_equal = all(torch.equal(a, b) for a, b in
                    zip(flat["this"], flat["other"]))
    diff = None if bit_equal else difference(flat["this"], flat["other"])
    del outs, flat
    graphs = {side: graph_of(lambda side=side: run(side), args.calls)
              for side in fns}
    times = {"this": [], "other": []}
    for pair in range(args.pairs):
        order = ("this", "other") if pair % 2 == 0 else ("other", "this")
        for side in order:
            times[side].append(replay_ms(graphs[side], args.calls))
    del graphs
    torch.cuda.empty_cache()
    return {"bit_equal": bit_equal, "diff": diff, "ms": {
        "this": spread(times["this"]), "other": spread(times["other"]),
        "ratio_other_over_this": spread(
            [o / t for t, o in zip(times["this"], times["other"])]),
        "pairs": args.pairs, "calls": args.calls}}


def build_info(this, other, lib: str, kernel: str, width: int) -> dict:
    """Both builds' ptxas report, SASS comparison and tensor-core
    instruction counts of ``kernel`` at ``width``."""
    codes = [sass(side[lib][0], kernel, width) for side in (this, other)]
    return {
        "width": width,
        "ptxas": {"this": ptxas_report(this[lib][1], kernel, width),
                  "other": ptxas_report(other[lib][1], kernel, width)},
        "sass": None if None in codes else compare_sass(*codes),
        "tensor_core": None if None in codes else {
            side: tensor_core(code)
            for side, code in zip(("this", "other"), codes)},
    }


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--other", type=Path, required=True,
                        help="root of the other checkout")
    parser.add_argument("--pairs", type=int, default=20)
    parser.add_argument("--calls", type=int, default=20)
    parser.add_argument("--kernels", default=None,
                        help="comma-separated C entries to compare "
                        "(default: all)")
    args = parser.parse_args()
    only = None if args.kernels is None else set(args.kernels.split(","))
    if not torch.cuda.is_available():
        log("kernel_ab: CUDA is not available")
        return 1
    sys.path.insert(0, str(ROOT))
    from dlrover_tpu_torch.ops import _build
    from dlrover_tpu_torch.ops import attention as att

    log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], check=True,
                       capture_output=True, text=True).stdout.strip())
    this, other = build_this(), build_other(args.other.resolve())
    calls = kernel_calls()
    report = []
    for lib, entries in LIBRARIES.items():
        other_lib = ctypes.CDLL(str(other[lib][0]))
        for entry in entries:
            if only is not None and entry not in only:
                continue
            kernel = f"{entry}_kernel"
            next(iter(calls[entry].values()))()  # binds this checkout's entry
            other_fn = getattr(other_lib, entry)
            argtypes = list(att._ENTRIES[entry][1])
            fns = {"this": _build._bound[entry], "other": other_fn}
            only_128 = (entry in att._BY_WIDTH and not takes_width(
                args.other.resolve(), lib, entry))
            if only_128:
                # the other checkout's entry has no head width argument
                argtypes = argtypes[1:]
                fns["other"] = lambda width, *rest, fn=other_fn: fn(*rest)
            other_fn.argtypes = argtypes + [ctypes.c_void_p]
            other_fn.restype = ctypes.c_int
            bare = (entry in PREPASS
                    and not runs_prepass(args.other.resolve(), entry))
            builds = {}
            for case, call in calls[entry].items():
                width = width_of(case)
                if width != D and only_128:
                    continue
                if width not in builds:
                    builds[width] = build_info(this, other, lib, kernel,
                                               width)
                line = {"kernel": entry, "case": case, **builds[width],
                        **compare(call, entry, fns, bare, args)}
                log(json.dumps({"kernel_ab": line}))
                report.append(line)
            _build._bound[entry] = fns["this"]
    OUT.mkdir(exist_ok=True)
    (OUT / "kernel_ab.json").write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
