#!/usr/bin/env python3
"""SASS instruction counts of K1 on bf16 planes, before and after its bf16
kernels: the Triton ``_flat_kernel`` of ``ops/sampling.py`` compiled for
bf16 planes (the kernel every bf16 plane took until the CUDA kernels of
``csrc/gaussian_sample_bf16.cu``), and those CUDA kernels.

    python3 benchmarks_torch/k1_sass.py    # from the repository root, on a CUDA card

``chip_smoke.py`` calls :func:`k1_counts` in its bf16 phase. A count is the
instructions (``cuobjdump -sass``) on a kernel's hot path, divided by the 8
elements a thread takes in both kernels (the Triton kernel: 8 warps over 4
sub-blocks of 512). The hot path (:func:`hot_path`) is the walk from the
entry that a thread with a whole group of 8 ordinary elements takes: an
unconditional branch is followed; a conditional forward branch is taken
where the code it skips holds a call, a loop or local memory (the
element-by-element path, sqrt's and division's slow paths, libdevice's
Payne-Hanek reduction of a large angle), else not; a predicated EXIT is
not taken; the walk ends at the first EXIT no predicate guards. Parts:

  * Philox: the Philox words alone (the Triton ``tl.randint4x`` probe below,
    the CUDA kernels' ``words`` mode), less a probe that stores the
    counters (Triton) or the words mode's one 16-byte store (CUDA);
  * Box-Muller: the normals (the ``tl.randn4x`` probe; the ``noise`` mode)
    less the Philox words (and, CUDA, the extra store);
  * bias index: the kernel with a bias less the kernel without (CUDA: its
    one-channel and two-channel runs, ``_channel_run``);
  * sqrt, division and the sample's float arithmetic: the kernel's float
    and special-function instructions less the draw's;
  * loads and stores: its memory instructions (LDG, STG, LDC);
  * address, masks, bf16 conversion and control: the rest.

The probes are compiled apart from the kernel, so the split of a total is
an estimate; the totals are exact counts of the hot path.
"""
from __future__ import annotations

import collections
import os
import re
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

ELEMENTS_PER_THREAD = 8
# the plane the counts compile for: poverty's commonest large BBB plane
# (64 channels of 111 x 111, a bias), at batch 2; the Triton instance
# specializes on the same divisibility as at batch 64
PLANE = (2, 64, 111, 111)
# opcode families, by prefix, first match
FAMILIES = (
    ("memory", ("LDG", "STG", "LDC", "ULDC", "LDS", "STS", "LDL", "STL", "LD.", "ST.")),
    ("special function", ("MUFU",)),
    ("float", ("FFMA", "FMUL", "FADD", "FSEL", "FSETP", "FMNMX", "F2F", "I2F", "F2I", "FRND", "FCHK", "HADD2",
               "HFMA2", "HMUL2", "FSET")),
    ("control", ("BRA", "EXIT", "BSSY", "BSYNC", "CALL", "RET", "NOP", "BAR", "WARPSYNC", "YIELD")),
)

# bound to triton.language by _probes before the probes are compiled
tl = None


def _words_probe(out, seed, GROUP: tl.constexpr):
    cols = tl.program_id(0) * GROUP + tl.arange(0, GROUP)
    r0, r1, r2, r3 = tl.randint4x(seed, cols)
    base = out + tl.program_id(0) * 4 * GROUP + tl.arange(0, GROUP)
    tl.store(base, r0)
    tl.store(base + GROUP, r1)
    tl.store(base + 2 * GROUP, r2)
    tl.store(base + 3 * GROUP, r3)


def _normals_probe(out, seed, GROUP: tl.constexpr):
    cols = tl.program_id(0) * GROUP + tl.arange(0, GROUP)
    z0, z1, z2, z3 = tl.randn4x(seed, cols)
    base = out + tl.program_id(0) * 4 * GROUP + tl.arange(0, GROUP)
    tl.store(base, z0)
    tl.store(base + GROUP, z1)
    tl.store(base + 2 * GROUP, z2)
    tl.store(base + 3 * GROUP, z3)


def _counters_probe(out, seed, GROUP: tl.constexpr):
    cols = tl.program_id(0) * GROUP + tl.arange(0, GROUP)
    r = (cols + seed).to(tl.uint32)
    base = out + tl.program_id(0) * 4 * GROUP + tl.arange(0, GROUP)
    tl.store(base, r)
    tl.store(base + GROUP, r)
    tl.store(base + 2 * GROUP, r)
    tl.store(base + 3 * GROUP, r)


def _probes():
    global tl
    import triton
    import triton.language

    tl = triton.language
    return {name: triton.jit(do_not_specialize=["seed"])(fn) for name, fn in
            (("words", _words_probe), ("normals", _normals_probe), ("counters", _counters_probe))}


def cuobjdump() -> str:
    found = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(found):
        raise RuntimeError("cuobjdump not found: put the CUDA toolkit's bin on PATH")
    return found


def sass_functions(path: str) -> dict:
    """{function name: [(address, predicate, opcode, operands), ...]} of
    ``path``'s SASS (a cubin or a shared library), in program order."""
    text = subprocess.run([cuobjdump(), "-sass", path], capture_output=True, text=True, check=True).stdout
    functions, body = {}, None
    for line in text.splitlines():
        head = re.search(r"Function : (\S+)", line)
        if head:
            body = functions.setdefault(head.group(1), [])
            continue
        ins = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);", line)
        if ins and body is not None:
            body.append((int(ins.group(1), 16), ins.group(2), ins.group(3), ins.group(4)))
    return functions


def _cold(region) -> bool:
    """A region a hot thread skips: a call, a backward branch (a loop) or
    local memory."""
    for address, _, op, operands in region:
        if op.startswith(("CALL", "STL", "LDL")):
            return True
        if op.startswith("BRA") and _target(operands) <= address:
            return True
    return False


def _target(operands: str) -> int:
    return int(re.findall(r"0x([0-9a-f]+)", operands)[-1], 16)


def hot_path(listing) -> list:
    """The opcodes on ``listing``'s hot path (the module docstring's walk)."""
    at = {address: i for i, (address, _, _, _) in enumerate(listing)}
    path, i, seen = [], 0, set()
    while i < len(listing) and i not in seen:
        seen.add(i)
        address, pred, op, operands = listing[i]
        path.append(op)
        if op == "EXIT" and pred is None:
            break
        if op.startswith("BRA"):
            j = at[_target(operands)]
            if pred is None or (j > i and _cold(listing[i + 1:j])):
                i = j
                continue
        i += 1
    return path


def family(op: str) -> str:
    for name, prefixes in FAMILIES:
        if op.startswith(prefixes):
            return name
    return "integer and address"


def per_element(ops) -> float:
    return len(ops) / ELEMENTS_PER_THREAD


def _cubin_of(compiled, workdir: str, name: str) -> str:
    path = os.path.join(workdir, f"{name}.cubin")
    with open(path, "wb") as f:
        f.write(compiled.asm["cubin"])
    return path


def _triton_kernel_cubins(torch, sampling, workdir: str) -> dict:
    """The Triton flat kernel compiled for bf16 planes of PLANE: forward and
    backward, with and without a bias (Philox draws), as ``_launch_triton``
    launches it."""
    flat, _ = sampling._build()
    dev = torch.device("cuda")
    n = 1
    for d in PLANE:
        n *= d
    a = torch.zeros(PLANE, dtype=torch.bfloat16, device=dev)
    var = torch.ones(PLANE, dtype=torch.bfloat16, device=dev)
    b = torch.ones(PLANE[1], dtype=torch.bfloat16, device=dev)
    out = torch.empty_like(a)
    group = sampling._GROUP
    cubins = {}
    for backward in (False, True):
        for bias in (False, True):
            compiled = flat[(-(-n // (4 * group)),)](
                a, var, b if bias else var, b if bias else var, a, out, a, n, PLANE[2] * PLANE[3], PLANE[1], 1, 5,
                0, 0, HAS_BIAS=bias, GIVEN=False, BACKWARD=backward, GROUP=group, DEVICE_SEED=False,
                num_warps=sampling._FLAT_WARPS)
            key = f"{'backward' if backward else 'forward'}{' bias' if bias else ''}"
            cubins[key] = _cubin_of(compiled, workdir, f"triton_{key.replace(' ', '_')}")
    probes = _probes()
    words = torch.empty(4 * group * 4, dtype=torch.int32, device=dev)
    normals = torch.empty(4 * group * 4, dtype=torch.float32, device=dev)
    for name, buf in (("words", words), ("normals", normals), ("counters", words)):
        compiled = probes[name][(4,)](buf, 5, GROUP=group, num_warps=sampling._FLAT_WARPS)
        cubins[f"probe {name}"] = _cubin_of(compiled, workdir, f"probe_{name}")
    torch.cuda.synchronize()
    return cubins


def _cuda_functions(sampling) -> dict:
    """The bf16 CUDA kernels' flat instances' hot paths by (mode, bias run,
    given), from the library the port loaded."""
    lib = sampling._library_bf16()
    found = {}
    for name, listing in sass_functions(lib._name).items():
        m = re.search(r"k1_flatILi(\d)ELi(\d)ELb([01])E", name)
        if m:
            found[tuple(int(g) for g in m.groups())] = hot_path(listing)
    return found


def split(total_ops, philox: float, box_muller: float, draw_float: float, bias: dict) -> dict:
    """One kernel's parts per element: Philox, Box-Muller and the bias index
    as measured apart, the rest of its hot path by opcode family
    (``draw_float``: the draw's float and special-function instructions a
    element, which the kernel's own include)."""
    fam = collections.Counter(family(op) for op in total_ops)
    total = per_element(total_ops)
    flt = (fam["float"] + fam["special function"]) / ELEMENTS_PER_THREAD - draw_float
    mem = fam["memory"] / ELEMENTS_PER_THREAD
    return {
        "total": total, "philox": philox, "box_muller": box_muller, **bias,
        "sqrt_division_float": flt, "loads_stores": mem,
        "address_masks_control": total - philox - box_muller - flt - mem,
        "special_function": fam["special function"] / ELEMENTS_PER_THREAD,
        "families": {k: v / ELEMENTS_PER_THREAD for k, v in sorted(fam.items())},
    }


def _float_ops(ops) -> int:
    return sum(family(op) in ("float", "special function") for op in ops)


def k1_counts(torch, sampling) -> dict:
    """{"before": {...}, "after": {...}}: per element, for the forward and
    the backward without a bias, the parts of the module docstring (the
    bias index from the kernels with one)."""
    with tempfile.TemporaryDirectory() as workdir:
        cubins = _triton_kernel_cubins(torch, sampling, workdir)
        triton_ops = {key: hot_path(next(iter(sass_functions(path).values()))) for key, path in cubins.items()}
    words, normals, counters = (triton_ops[f"probe {k}"] for k in ("words", "normals", "counters"))
    t_philox = (len(words) - len(counters)) / ELEMENTS_PER_THREAD
    t_box_muller = (len(normals) - len(words)) / ELEMENTS_PER_THREAD
    t_draw_float = (_float_ops(normals) - _float_ops(counters)) / ELEMENTS_PER_THREAD
    cuda = _cuda_functions(sampling)
    fwd, bwd, noise, words_mode = (sampling._BF16_FORWARD, sampling._BF16_BACKWARD, sampling._BF16_NOISE,
                                   sampling._BF16_WORDS)
    # words stores one 16-byte vector, noise two
    c_words, c_noise = cuda[(words_mode, 0, 0)], cuda[(noise, 0, 0)]
    c_philox = (len(c_words) - 1) / ELEMENTS_PER_THREAD
    c_box_muller = (len(c_noise) - len(c_words) - 1) / ELEMENTS_PER_THREAD
    c_draw_float = _float_ops(c_noise) / ELEMENTS_PER_THREAD
    counts = {"before": {}, "after": {}}
    for label, mode in (("forward", fwd), ("backward", bwd)):
        counts["before"][label] = split(
            triton_ops[label], t_philox, t_box_muller, t_draw_float,
            {"bias_index": per_element(triton_ops[f"{label} bias"]) - per_element(triton_ops[label])})
        base = cuda[(mode, 0, 0)]
        counts["after"][label] = split(
            base, c_philox, c_box_muller, c_draw_float,
            {"bias_index": per_element(cuda[(mode, 3, 0)]) - per_element(base),
             "bias_index_two_channels": per_element(cuda[(mode, 2, 0)]) - per_element(base)})
    return counts


def print_counts(counts, card: str = "") -> None:
    parts = ("total", "philox", "box_muller", "bias_index", "bias_index_two_channels", "sqrt_division_float",
             "loads_stores", "address_masks_control", "special_function")
    for label in ("forward", "backward"):
        for when, route in (("before", "Triton _flat_kernel"), ("after", "CUDA k1_flat")):
            c = counts[when][label]
            print(f"K1 bf16 SASS per element, {label}, {when} ({route}): "
                  + ", ".join(f"{p} {c[p]:.2f}" for p in parts if p in c) + (f" [{card}]" if card else ""))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("k1_sass: no CUDA card", file=sys.stderr)
        return 1
    from beyond_deep_ensembles_tpu_torch.ops import sampling

    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(card)
    print_counts(k1_counts(torch, sampling), card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
