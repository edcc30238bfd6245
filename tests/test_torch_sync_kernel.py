"""Kernel S1's algorithm (csrc/sync_scan.cu) on the CPU.

A numpy mirror of the kernel (one carrier at a time, scalar int32 state,
the .cu file's loop with its clamps, over the next-match maps that
sync_vec.next_match_maps builds for it) is held, with exact equality on
every OUT_KEYS plane and on the carry, against sync_vec.sync_scan_plain
and against tetra_tpu.phy.sync_vec.sync_scan. The kernel itself runs
only on a card (tests/test_torch_cuda.py)."""
import pathlib
import re

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from tests._torch_util import t, n
from tests.test_sync_vec import make_stream
from tests.test_torch_soft import _corrupted_streams

from tetra_tpu import constants as JC
from tetra_tpu.phy import burst as j_burst, sync as j_sync, sync_vec as j_sv

from tetra_tpu_torch import kernels
from tetra_tpu_torch.phy import sync_vec as sv

BIG = 1 << 27
TS = JC.BITS_PER_TS
SYNC_OFF = JC.SYNC_TRAIN_OFFSET
NORM_OFF = JC.NORM_TRAIN_OFFSET
RING = 4096
LENS = (38, 22, 22)
FLAG_KEYS = ("burst", "emit", "found", "bad", "lost")


def mirror(bits, carry, steps: int, feed: int = 64, tol: int = 0):
    """The kernel's loop in numpy: bits [B, L] int8, carry [5, B] int32
    (state, buf_start, nbuf, nfs, slot_index). Returns (carry_out [5, B],
    out {key: [steps, B]}, seen) where seen counts the branches the run
    took (ring overflow, KNOW_FSTART moving buf_start backwards, a
    negative window start)."""
    B, L = bits.shape
    nm = n(sv.next_match_maps(t(bits), tol)).astype(np.int64)  # [3, B, L+1]
    pat0 = sv._PAT0
    pat1eq = sv._PAT1_EQ_PAT0
    out = {k: np.zeros((steps, B), bool if k in FLAG_KEYS else np.int32)
           for k in sv.OUT_KEYS}
    seen = {"ring_overflow": 0, "kf_backwards": 0, "negative_start": 0}
    carry_out = np.zeros((5, B), np.int32)
    clamp = lambda p: min(max(p, 0), L)

    def vis20_at(b, p, ci):
        if p >= L:
            return False
        prev = int(bits[b, p - 1]) if p > 0 else 0
        return prev == pat0[ci]

    def first_match(b, ci, a, lim):
        q = int(nm[ci, b, clamp(a)])
        for _ in range(2):
            k = q - a
            v20 = vis20_at(b, clamp(q), ci)
            vis = k >= 21 or (k == 20 and v20)
            if pat1eq[ci]:
                vis = vis or (k == 19 and v20)
            if q < L and not vis:
                q = int(nm[ci, b, clamp(q + 1)])
        return q if (q + LENS[ci] <= lim and q < L) else BIG

    def match_at(b, ci, p, blim):
        pc = clamp(p)
        return pc < L and int(nm[ci, b, pc]) == pc and p + LENS[ci] <= blim

    for b in range(B):
        state, buf_start, nbuf, nfs, slot_index = (int(x) for x in carry[:, b])
        for step in range(steps):
            delta = max(feed - (RING - nbuf), 0)
            seen["ring_overflow"] += delta > 0
            nbuf = nbuf + feed - delta
            buf_start += delta
            st, a0 = state, buf_start
            kf = st == 1 and a0 + nbuf >= nfs
            nbuf_u = nbuf
            if kf:
                seen["kf_backwards"] += nfs < a0
                nbuf -= nfs - a0
                buf_start = nfs
            slot, blim = buf_start, buf_start + nbuf
            seen["negative_start"] += slot < 0
            q = [first_match(b, ci, slot, blim) for ci in range(3)]
            q0 = q[0]
            found = st == 0 and nbuf_u >= 2 * TS and q0 < BIG
            found_rel = q0 - a0 if found else 0
            state_u = 1 if found else st
            nfs_u = q0 + (TS - SYNC_OFF) if found else nfs
            nfs_k = nfs + TS if kf else nfs_u
            state_k = 2 if kf else state_u
            lk = (st == 2 or kf) and nbuf >= TS
            key = BIG * 4
            for ci in range(3):
                key = min(key, q[ci] * 4 + ci if q[ci] < BIG else BIG * 4)
            has = key < BIG * 4
            col = key & 3 if has else -1
            qw = key >> 2
            if tol:
                e0 = match_at(b, 0, slot + SYNC_OFF, blim)
                e1 = match_at(b, 1, slot + NORM_OFF, blim)
                e2 = match_at(b, 2, slot + NORM_OFF, blim)
                if e0 or e1 or e2:
                    col = 0 if e0 else (1 if e1 else 2)
                    qw = slot + SYNC_OFF if e0 else slot + NORM_OFF
                has = has or e0 or e1 or e2
            rel = qw - slot
            is_sync = lk and col == 0
            sync_ok = is_sync and rel == SYNC_OFF
            is_norm = lk and col in (1, 2)
            norm_ok = is_norm and rel == NORM_OFF
            lost = lk and not has
            bad = (is_sync and not sync_ok) or (is_norm and not norm_ok)
            state = 0 if (is_sync and not sync_ok) or lost else state_k
            slot_index += int(lk)
            adv = TS if lk else 0
            for k, v in (("burst", lk), ("emit", sync_ok or norm_ok),
                         ("col", col), ("slot", slot), ("found", found),
                         ("found_rel", found_rel),
                         ("found_q", q0 if found else 0), ("bad", bad),
                         ("bad_rel", rel if bad else 0), ("lost", lost)):
                out[k][step, b] = v
            buf_start += adv
            nbuf -= adv
            nfs = nfs_k + adv
        carry_out[:, b] = (state, buf_start, nbuf, nfs, slot_index)
    return carry_out, out, seen


def run_all(bits, carry, steps: int, tol: int = 0, fed: int = 0):
    """Mirror, sync_scan_plain and the JAX sync_scan on the same inputs,
    held equal on every plane (values and type) and on the carry;
    returns the mirror's (carry, out, seen)."""
    bits = np.ascontiguousarray(bits, np.int8)
    carry = np.asarray(carry, np.int32)
    m_carry, m_out, seen = mirror(bits, carry, steps, tol=tol)
    (*p_carry, p_fed), p_out = sv.sync_scan_plain(
        t(bits), *(t(c) for c in carry), fed, steps, tol=tol)
    (*j_carry, j_fed), j_out = j_sv.sync_scan(
        jnp.asarray(bits), *map(jnp.asarray, carry), np.int32(fed), steps,
        tol=tol)
    for k in sv.OUT_KEYS:
        assert n(p_out[k]).dtype == m_out[k].dtype, k
        assert np.array_equal(n(p_out[k]), m_out[k]), k
        assert np.array_equal(np.asarray(j_out[k]), m_out[k]), k
        assert m_out[k].shape == (steps, bits.shape[0])
    for i in range(5):
        assert np.array_equal(n(p_carry[i]), m_carry[i]), i
        assert np.array_equal(np.asarray(j_carry[i]), m_carry[i]), i
    assert p_fed == int(j_fed) == fed + 64 * steps
    return m_carry, m_out, seen


def streams(seeds, n_frames: int = 3):
    rows = [make_stream(s, n_frames=n_frames) for s in seeds]
    L = min(len(r) for r in rows)
    return np.stack([r[:L] for r in rows]).astype(np.int8)


@pytest.mark.parametrize("seed", [0, 1])
def test_mirror_chunked_streams(seed):
    """test_torch_sync's relocking streams in three uneven chunks, the
    carry handed on as the fast path does."""
    bits = streams([100 * seed + b for b in range(6)])
    L = bits.shape[1]
    rng = np.random.default_rng(seed)
    carry = np.zeros((5, 6), np.int32)
    fed = 0
    emitted = 0
    for steps in (int(rng.integers(10, 40)), int(rng.integers(10, 40)),
                  (L - 64 * 80) // 64):
        m_carry, out, _ = run_all(bits, carry, steps, fed=fed)
        emitted += int(out["emit"].sum())
        carry = m_carry.copy()
        carry[4] = 0
        fed += 64 * steps
    assert emitted > 0


@pytest.mark.parametrize("chunks", [1, 3])
def test_mirror_tolerant_streams(chunks):
    """test_torch_soft's corrupted streams at tol 2 (the expected-offset
    override), whole and in uneven chunks."""
    bits = _corrupted_streams(seed=30 + chunks)
    total = (bits.shape[1] - 64 * 10) // 64
    cuts = [total] if chunks == 1 else [17, 40, total - 57]
    carry = np.zeros((5, bits.shape[0]), np.int32)
    emitted = 0
    fed = 0
    for steps in cuts:
        m_carry, out, _ = run_all(bits, carry, steps, tol=2, fed=fed)
        emitted += int(out["emit"].sum())
        carry = m_carry.copy()
        carry[4] = 0
        fed += 64 * steps
    assert emitted > 0


@pytest.mark.parametrize("steps", [0, 1])
def test_mirror_zero_and_one_step(steps):
    """steps 0 (empty planes, the carry unchanged) and 1, from a locked
    carry part-way into a stream."""
    bits = streams([7, 8, 9])
    carry = np.array([[2, 0, 1], [600, 0, 1000], [900, 100, 1500],
                      [700, 0, 1600], [3, 0, 0]], np.int32)
    m_carry, out, _ = run_all(bits, carry, steps)
    if steps == 0:
        assert np.array_equal(m_carry, carry)


def test_mirror_one_carrier():
    """B 1: one carrier through a whole stream."""
    bits = streams([11])
    steps = (bits.shape[1] - 64) // 64
    _, out, _ = run_all(bits, np.zeros((5, 1), np.int32), steps)
    assert out["emit"].sum() > 0


@pytest.mark.parametrize("tol", [0, 2])
def test_mirror_ring_overflow(tol):
    """A carrier that never locks (noise) fills the 4096-bit ring, after
    which every step drops the oldest bits (delta > 0); beside it a
    locking carrier."""
    rng = np.random.default_rng(5)
    bits = streams([12, 13])
    bits[0] = rng.integers(0, 2, bits.shape[1])
    steps = (bits.shape[1] - 64) // 64
    _, out, seen = run_all(bits, np.zeros((5, 2), np.int32), steps, tol=tol)
    assert seen["ring_overflow"] > 0
    assert not out["found"][:, 0].any() and out["found"][:, 1].any()


@pytest.mark.parametrize("tol", [0, 2])
def test_mirror_know_fstart_backwards_and_nfs_minus_one(tol):
    """KNOW_FSTART carries whose next frame start lies before the buffer
    start (buf_start moves backwards), one at nfs -1 (MultiSync passes
    max(rel(nfs), -1)), so the window starts at a negative position and
    every lookup clamps."""
    bits = streams([21, 22, 23, 24])
    carry = np.array([[1, 1, 1, 1], [500, 300, 0, 40],
                      [1200, 2000, 600, 900], [300, -1, -1, 10],
                      [0, 0, 0, 0]], np.int32)
    steps = (bits.shape[1] - 3000) // 64
    _, out, seen = run_all(bits, carry, steps, tol=tol)
    assert seen["kf_backwards"] >= 4
    assert seen["negative_start"] > 0
    assert out["burst"][0].all()


def slipped(seed: int, n_frames: int = 4) -> np.ndarray:
    """make_stream with three bit slips after the first lock: 1-5 bits
    deleted or inserted, so the next training sequence sits off its
    expected offset."""
    rng = np.random.default_rng(seed)
    s = make_stream(seed, n_frames=n_frames)
    at = rng.choice(np.arange(2000, len(s) - 200), 3, replace=False)
    for p in sorted(at)[::-1]:
        k = int(rng.integers(1, 6))
        s = (np.delete(s, np.arange(p, p + k)) if rng.random() < 0.5
             else np.insert(s, p, rng.integers(0, 2, k)))
    return s


@pytest.mark.parametrize("tol", [0, 2])
@pytest.mark.parametrize("seed", [2, 3, 4])
def test_mirror_lock_loss_bad_offsets_reacquisition(seed, tol):
    """Corrupted streams with bit slips: carriers see bad offsets, lose
    lock and acquire SYNC again."""
    rows = [slipped(300 + 10 * seed + b) for b in range(5)]
    L = min(len(r) for r in rows)
    bits = np.stack([r[:L] for r in rows]).astype(np.int8)
    _, out, _ = run_all(bits, np.zeros((5, 5), np.int32), (L - 64) // 64,
                        tol=tol)
    assert out["lost"].any() and out["bad"].any()
    assert (out["found"].sum(0) >= 2).any()


@pytest.mark.parametrize("tol", [0, 2])
def test_next_match_maps_brute_force(tol):
    """The kernel's maps against a numpy scan of the JAX match map."""
    bits = streams([40, 41])[:, :3000]
    nm = n(sv.next_match_maps(t(bits), tol))
    match = np.asarray(j_burst.train_seq_match(jnp.asarray(bits), j_sv._MASK,
                                               tol=tol))[..., :3]
    B, L = bits.shape
    assert nm.shape == (3, B, L + 1) and nm.dtype == np.int32
    for ci in range(3):
        for b in range(B):
            want = np.full(L + 1, L)
            for p in range(L - 1, -1, -1):
                want[p] = p if match[b, p, ci] else want[p + 1]
            assert np.array_equal(nm[ci, b], want)
    assert (nm[..., :L] < L).any()


def test_cpu_tensor_never_loads_the_kernels(monkeypatch):
    """sync_scan on CPU tensors is the plain version, bit for bit, and
    never builds or loads the kernel library."""
    def boom(*a, **k):
        raise AssertionError("kernel library touched on the CPU")
    monkeypatch.setattr(kernels, "lib", boom)
    monkeypatch.setattr(kernels, "build", boom)
    bits = streams([50, 51])
    z = t(np.zeros(2, np.int32))
    before = sv.sync_scan.launches
    steps = (bits.shape[1] - 64) // 64
    (*carry, fed), out = sv.sync_scan(t(bits), z, z, z, z, z, 0, steps)
    (*pc, pfed), pout = sv.sync_scan_plain(t(bits), z, z, z, z, z, 0, steps)
    assert sv.sync_scan.launches == before
    assert fed == pfed
    for a, b in zip(carry, pc):
        assert torch.equal(a, b)
    for k in sv.OUT_KEYS:
        assert torch.equal(out[k], pout[k]), k


def test_other_device_raises():
    """A device that is neither the CPU nor a card has no version."""
    bits = torch.zeros((2, 640), dtype=torch.int8, device="meta")
    z = torch.zeros(2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        sv.sync_scan(bits, z, z, z, z, z, 0, 3)


def test_kernel_constants_match_the_protocol():
    """The protocol constants compiled into csrc/sync_scan.cu (its
    `constexpr int` lines) are the JAX package's and sync_vec's, in
    tt_sync_scan_constants' order (sync_vec checks the built library
    against the same tuple before S1's first launch)."""
    src = (pathlib.Path(sv.__file__).parent.parent / "csrc" / "sync_scan.cu"
           ).read_text()
    k = {}
    for decl in re.findall(r"^constexpr int ([^;]+);", src, re.M):
        for name, value in re.findall(r"(\w+) = (-?\d+)(?=,|$)", decl):
            k[name] = int(value)
    built = (k["kTs"], k["kRing"], k["kSyncOff"], k["kNormOff"],
             *(k[f"kLen{c}"] for c in range(3)),
             *(k[f"kPat0_{c}"] for c in range(3)),
             *(k[f"kPat1Eq{c}"] for c in range(3)))
    seqs = [j_sync._SEQS[c] for c in j_sync._LOCKED_COLS]
    want = (TS, RING, SYNC_OFF, NORM_OFF, *LENS,
            *(int(s[0]) for s in seqs), *(int(s[1] == s[0]) for s in seqs))
    assert built == want == sv._KERNEL_CONSTANTS


def test_sync_scan_is_a_counted_wrapper():
    """kernels.launches() reports S1 under the name sync_scan."""
    assert kernels.wrappers()["sync_scan"] is sv.sync_scan
    assert "sync_scan" in kernels.launches()
