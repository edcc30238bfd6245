"""k4_roofline: kernel K4 (csrc/viterbi_segmented.cu, the soft Viterbi of
the soft receiver's FEC) against its bound: the least time for its
function on each call's shapes (k4_bound) over K4's device time in the
profiled sub-window, %.

The calls and their shapes come from the annotated decode_segmented_k4
calls that lmac/fused.decode_slots_fused makes. The time comes from the
kernels by name, because a kernel launched through the library's C
interface is not counted in the annotation's own device time (PyTorch's
profiler links no such launch to the range that made it). K4 and K6
launch one kernel template, told apart by its tag type, K4 or K6; a
program from before the tag named K4 by its 16 rows a block, K6's 8.
Where K4 ran, its launches must equal its calls (one launch a call): a
profile without them, or with another count, raises."""
import re

from portbench import bounds

CALLS = {"k4": [("tetra_tpu_torch.lmac.fused", "decode_segmented_k4")]}

F32_OPS = bounds.F32_FLOPS / 2    # f32 adds, compares and selects
N_GEN = 4                         # generators of the control channels' code


def viterbi_ops(rows: int, n_sym: int, n_gen: int) -> int:
    """A radix-2 16-state decode (chip_smoke.viterbi_ops): per row and
    step the 2^n_gen distinct branch metrics (n_gen - 1 adds each), 16
    add-compare-selects (4 each) and a traceback step."""
    return rows * n_sym * (2 ** n_gen * (n_gen - 1) + 64 + 1)


def k4_bound(rows: int, n_sym: int, n_restarts: int) -> float:
    """Seconds: f32 soft values read once (N_GEN a step), the restart
    mask (1 B a boundary) and the bits written (1 B a step), against the
    Viterbi's f32 operations (chip_smoke.check_k4's bound)."""
    return bounds.bound(4 * rows * N_GEN * n_sym + rows * n_restarts
                        + rows * n_sym,
                        viterbi_ops(rows, n_sym, N_GEN), F32_OPS)


# K4's launches as the profiler names them (demangled), by the tag type
K4_KERNEL = re.compile(r"viterbi_segmented_kernel<[^<>]*\bK4\s*>")
# a program from before the tag: K4 is the instantiation of 16 rows
UNTAGGED_K4 = re.compile(r"viterbi_segmented_kernel<\s*\d+\s*,\s*\d+\s*,"
                         r"\s*16\s*>")


def k4_time(kernels: dict) -> tuple[float, int]:
    """K4's device seconds and launches among the profile's kernels
    {name: (seconds, launches)}: by its tag, or else by its 16 rows."""
    for pattern in (K4_KERNEL, UNTAGGED_K4):
        hits = [v for name, v in kernels.items() if pattern.search(name)]
        if hits:
            return sum(t for t, _ in hits), sum(n for _, n in hits)
    return 0.0, 0


def read(ctx):
    p = ctx.prof
    if not p:
        return None
    calls = p["args"].get("k4", [])
    if not calls:
        return None
    t, launches = k4_time(p["kernels"])
    if launches != len(calls) or t <= 0:
        raise RuntimeError(
            f"k4_roofline: {len(calls)} calls of decode_segmented_k4 but "
            f"{launches} launches of K4's kernel in the profile")
    need = sum(k4_bound(int(a[0].shape[0]), int(a[2]), int(a[1].shape[1]))
               for a, _ in calls)
    return 100.0 * need / t
