"""Steady-state locked receiver step: baseband -> decoded blocks (port of
tetra_tpu.lmac.steady).

Once locked, the receiver only needs to (a) demodulate, (b) cut slots
at the known grid, (c) check the training sequence at the slot's two
legal offsets (sync@214 / normal@244, tetra_burst_sync.c:123,133) and
(d) run the FEC. `locked_step_ri` chains them over [carriers, slots]:
the receiver between re-acquisitions, and the shape of the JAX
package's steady benchmark stages.

fast="pallas" runs the demod through kernel K5 (phy.demod_fused,
CUDA) and the FEC through kernel K1, the fused decode
(decoders=("fused",)) or the per-kind burst decoders. fast="eq" puts
the per-slot pilot-aided equaliser (phy.equalize, plain PyTorch) in
front of the same FEC; fast=False is the angle demod and slicer.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from tetra_tpu_torch import constants as C
from tetra_tpu_torch.device import resolve_device
from tetra_tpu_torch.lmac import fused as fused_mod, pipeline
from tetra_tpu_torch.phy import demod_fused, dqpsk, equalize

__all__ = ["verify_train_seq", "classify_train_seq", "locked_step_bits",
           "locked_step_iq", "locked_step_fused", "locked_step_ri",
           "grouped_decode"]

DECODERS = ("sync", "schf", "ndb")


@functools.lru_cache(maxsize=4)
def _templates(device: torch.device) -> tuple:
    """±1 training templates y, n, p as float32 on `device`, copied
    there once."""
    return tuple(torch.as_tensor((1 - 2 * s.astype(np.int32))
                                 .astype(np.float32), device=device)
                 for s in (C.TRAIN_Y, C.TRAIN_N, C.TRAIN_P))


def _windows(slots: torch.Tensor):
    """±1 training windows (sync [..., 38], normal [..., 22]) and the
    ±1 templates y, n, p. Only the windows are cast to float."""
    tmpl = _templates(slots.device)
    w_sync = 1.0 - 2.0 * slots[
        ..., C.SYNC_TRAIN_OFFSET:C.SYNC_TRAIN_OFFSET + 38].to(torch.float32)
    w_norm = 1.0 - 2.0 * slots[
        ..., C.NORM_TRAIN_OFFSET:C.NORM_TRAIN_OFFSET + 22].to(torch.float32)
    return w_sync, w_norm, tmpl


def classify_train_seq(slots: torch.Tensor,
                       min_agree: float = 0.75) -> torch.Tensor:
    """Noise-tolerant classification of slots [..., 510]: the nearest
    training template by bit-agreement fraction (0 sync / 1 SCH/F /
    2 NDB), -1 below `min_agree`. Used by the soft steady path, where an
    exact match would drop slots on a single training-bit error."""
    w_sync, w_norm, (y, nseq, p) = _windows(slots)
    fr = lambda corr, n: (corr / n + 1.0) * 0.5
    stacked = torch.stack([fr(w_sync @ y, 38.0), fr(w_norm @ nseq, 22.0),
                           fr(w_norm @ p, 22.0)], dim=-1)
    kind = torch.argmax(stacked, dim=-1).to(torch.int32)
    return torch.where(stacked.amax(dim=-1) >= min_agree, kind, -1)


def verify_train_seq(slots: torch.Tensor) -> torch.Tensor:
    """Classify aligned slots [..., 510] by their training sequence:
    int32 0 = sync (y@214), 1 = SCH/F (n@244), 2 = NDB (p@244), -1 =
    no exact match (lock lost)."""
    w_sync, w_norm, (y, nseq, p) = _windows(slots)
    is_sync = (w_sync @ y) == 38.0
    is_n = (w_norm @ nseq) == 22.0
    is_p = (w_norm @ p) == 22.0
    kind = torch.where(is_sync, 0, torch.where(is_n, 1,
                                               torch.where(is_p, 2, -1)))
    return kind.to(torch.int32)


def locked_step_fused(slots: torch.Tensor, inits) -> dict:
    """Kind-compacted steady step: classify each slot's training
    sequence, then one K1 pass decodes every slot under its own kind
    (lmac.fused). inits [C] broadcast to [C, 1] against [C, S]."""
    kinds = verify_train_seq(slots)
    inits = torch.as_tensor(inits, dtype=torch.int64, device=slots.device)
    inits = inits.reshape(inits.shape + (1,) * (slots.dim() - 1 - inits.dim()))
    return fused_mod.decode_slots_fused(slots, inits, kinds)


def locked_step_bits(slots: torch.Tensor, inits,
                     decoders: tuple = DECODERS) -> dict:
    """Aligned slots [C, S, 510] + per-carrier scrambling codes [C] ->
    decoded blocks + per-slot training classification.

    Every configured burst interpretation runs on every slot and the
    slot's kind selects the result. decoders=("fused",) takes the
    kind-compacted single pass instead (locked_step_fused). Slots whose
    kind has no configured decoder report crc_ok False."""
    decoders = tuple(decoders)
    if decoders == ("fused",):
        return locked_step_fused(slots, inits)
    if not set(decoders) <= set(DECODERS):
        raise ValueError(f"unknown decoders {decoders}")
    kinds = verify_train_seq(slots)
    inits_b = torch.as_tensor(inits, dtype=torch.int64,
                              device=slots.device)[:, None]
    out = {"kinds": kinds}
    false = torch.zeros(kinds.shape, dtype=torch.bool, device=slots.device)
    ok_sync = ok_schf = ok_ndb = false
    sync_bbk = norm_bbk = None
    if "sync" in decoders:
        sync = pipeline.decode_sync_burst(slots, inits_b)
        out.update(sb1=sync["SB1"], sb2=sync["SB2"])
        sync_bbk = sync["BBK"]
        ok_sync = sync["SB1"].crc_ok & sync["SB2"].crc_ok
    if "schf" in decoders:
        schf = pipeline.decode_schf_burst(slots, inits_b)
        out["schf"] = schf["SCH_F"]
        norm_bbk = schf["BBK"]
        ok_schf = schf["SCH_F"].crc_ok
    if "ndb" in decoders:
        ndb = pipeline.decode_ndb_burst(slots, inits_b)
        out.update(ndb1=ndb["NDB1"], ndb2=ndb["NDB2"])
        if norm_bbk is None:
            norm_bbk = ndb["BBK"]
        ok_ndb = ndb["NDB1"].crc_ok & ndb["NDB2"].crc_ok
    # the broadcast block sits at SB_BBK_OFFSET on sync bursts and at
    # NDB_BBK1/2 on normal bursts (tetra_burst.c:346-372), so with mixed
    # decoders it is selected by kind
    if sync_bbk is not None and norm_bbk is not None:
        is_sync = kinds == 0
        out["bbk"] = pipeline.BlockResult(
            torch.where(is_sync[..., None], sync_bbk.type1, norm_bbk.type1),
            torch.where(is_sync, sync_bbk.crc_ok, norm_bbk.crc_ok),
            torch.where(is_sync[..., None], sync_bbk.type2, norm_bbk.type2))
    elif sync_bbk is not None or norm_bbk is not None:
        out["bbk"] = sync_bbk if sync_bbk is not None else norm_bbk
    out["crc_ok"] = torch.where(
        kinds == 0, ok_sync,
        torch.where(kinds == 1, ok_schf,
                    torch.where(kinds == 2, ok_ndb, false)))
    return out


def locked_step_ri(re: torch.Tensor, im: torch.Tensor, inits,
                   phase_bit: int = 0, sps: int = 2,
                   n_slots: int | None = None, fast=True,
                   decoders: tuple = DECODERS) -> dict:
    """Full chain from planar baseband: demod -> slot cut -> training
    check -> FEC. re, im [C, T] float32 at sps samples per symbol, slot
    boundaries at bit `phase_bit`, inits [C] scrambling codes.

    fast=True: the trig-free hard demod (dqpsk.demodulate_hard_ri);
    fast="pallas": the same demod as kernel K5 (CUDA, phy.demod_fused;
    the plain version on CPU tensors), with the slot cut on its packed
    per-symbol decisions when phase_bit is even; fast="slotwise": per-slot
    timing re-pick and blind residual-CFO correction for degraded
    signals; fast="soft": the slotwise soft values through the fused
    decode with kernel K4 and nearest-template classification;
    fast="eq": the per-slot pilot-aided T/2 equaliser for multipath
    channels (sps 2), then the hard FEC; fast=False: the angle demod
    (dqpsk.demodulate_ri) and the reference slicer (float_to_bits)."""
    if fast not in (True, False, "pallas", "slotwise", "soft", "eq"):
        raise ValueError(f"unknown fast={fast!r}")
    inits = torch.as_tensor(inits, dtype=torch.int64, device=re.device)
    if fast in ("slotwise", "soft", "eq"):
        S = n_slots if n_slots is not None else \
            (re.shape[-1] * 2 // sps - phase_bit) // C.BITS_PER_TS
        if fast == "soft":
            soft = dqpsk.demodulate_soft_slotwise_ri(re, im, S,
                                                     phase_bit=phase_bit,
                                                     sps=sps)
            hard = (soft <= 0).to(torch.int8)
            kinds = classify_train_seq(hard)
            out = fused_mod.decode_slots_fused(soft, inits[:, None], kinds,
                                               soft_input=True)
            out["bits"] = hard.reshape(hard.shape[0], S * C.BITS_PER_TS)
            return out
        demod = (equalize.demodulate_hard_eq_slotwise_ri if fast == "eq"
                 else dqpsk.demodulate_hard_slotwise_ri)
        slots = demod(re, im, S, phase_bit=phase_bit, sps=sps)
        out = locked_step_bits(slots, inits, decoders=decoders)
        out["bits"] = slots.reshape(slots.shape[0], S * C.BITS_PER_TS)
        return out
    if fast == "pallas" and phase_bit % 2 == 0:
        # slot framing cut on the demod's packed per-symbol decisions
        S = n_slots if n_slots is not None else \
            (re.shape[-1] * 2 // sps - phase_bit) // C.BITS_PER_TS
        slots, bits = demod_fused.demodulate_hard_slots_ri_pallas(
            re, im, S, phase_bit=phase_bit, sps=sps)
        out = locked_step_bits(slots, inits, decoders=decoders)
        out["bits"] = bits[..., phase_bit:]
        return out
    if fast == "pallas":
        bits = demod_fused.demodulate_hard_ri_pallas(re, im, sps=sps)
    elif fast:
        bits = dqpsk.demodulate_hard_ri(re, im, sps=sps)
    else:
        bits = dqpsk.float_to_bits(dqpsk.demodulate_ri(re, im, sps=sps))
    bits = bits[..., phase_bit:]
    S = n_slots if n_slots is not None else bits.shape[-1] // C.BITS_PER_TS
    slots = bits[..., :S * C.BITS_PER_TS].reshape(
        *bits.shape[:-1], S, C.BITS_PER_TS)
    out = locked_step_bits(slots, inits, decoders=decoders)
    out["bits"] = bits
    return out


def locked_step_iq(iq, inits, phase_bit: int = 0, sps: int = 2,
                   n_slots: int | None = None, device=None) -> dict:
    """Complex-input convenience wrapper over locked_step_ri: iq [C, T]
    (numpy or a complex tensor) is split into float32 planes on
    `device` (a tensor's own device, else device.resolve_device)."""
    if isinstance(iq, torch.Tensor):
        dev = iq.device if device is None else resolve_device(device)
        iq = iq.to(dev)
        re, im = iq.real.to(torch.float32), iq.imag.to(torch.float32)
    else:
        dev = resolve_device(device)
        iq = np.asarray(iq)
        re = torch.as_tensor(np.real(iq).astype(np.float32), device=dev)
        im = torch.as_tensor(np.imag(iq).astype(np.float32), device=dev)
    return locked_step_ri(re.contiguous(), im.contiguous(), inits,
                          phase_bit=phase_bit, sps=sps, n_slots=n_slots)


def _bucket(n: int) -> int:
    """Next power-of-two bucket (tetra_tpu bounds its compiled shapes
    with it; kept so that batches are padded alike)."""
    b = 1
    while b < n:
        b <<= 1
    return b


def grouped_decode(slots, slot_inits, kinds, device=None) -> dict:
    """Mixed-traffic decode without redundant interpretations: gather
    each kind's slots into its own batch (padded to a power-of-two
    bucket by repeating the last slot) and run only that kind's
    burst decoder.

    slots [N, 510], slot_inits [N] scrambling codes, kinds [N] (0 sync
    / 1 schf / 2 ndb, from verify_train_seq), host arrays. Returns
    {kind_name: (indices, {block: BlockResult of numpy arrays})}."""
    dev = resolve_device(device)
    slots = np.asarray(slots)
    slot_inits = np.asarray(slot_inits, dtype=np.int64)
    kinds = np.asarray(kinds)
    out = {}
    groups = {"sync": (0, pipeline.decode_sync_burst),
              "schf": (1, pipeline.decode_schf_burst),
              "ndb": (2, pipeline.decode_ndb_burst)}
    for name, (kind_val, fn) in groups.items():
        idx = np.nonzero(kinds == kind_val)[0]
        if len(idx) == 0:
            continue
        b = _bucket(len(idx))
        pad_idx = np.concatenate([idx, np.repeat(idx[-1], b - len(idx))])
        batch = torch.as_tensor(slots[pad_idx].astype(np.int8), device=dev)
        inits = torch.as_tensor(slot_inits[pad_idx], device=dev)
        res = fn(batch, inits)
        out[name] = (idx, {
            k: pipeline.BlockResult(*(f[:len(idx)].cpu().numpy()
                                      for f in v))
            for k, v in res.items()})
    return out
