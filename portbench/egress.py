"""The receiver's egress under the benchmark: traffic dumps and TCH/S
voice frames, as `tetra-rx -d DIR` (with `--voice`) writes them.

A configuration turns it on with the key

    "egress": true

Each pass's fresh receiver then gets `dumpdir=` a new empty directory
under the process's TMPDIR (`tempfile.mkdtemp`), made before the pass's
clock starts and removed after it stops, and `decode_voice=True`. The
receiver appends inside the calls that collect each chunk, as the live
receiver does: per carrier `carrier<i>/traffic_<usage>_<tn>.out` (a
690-int16 block a traffic slot), `.txt` (a line a slot) and
`voice_<usage>_<tn>.cod` (35 bytes a slot). After a window pass's clock
stops its directory is listed (`listing`); the check pass's files are
also read whole (`contents`) and held to the plain reference
(`evaluate`, `reference/voice.py`). A configuration without the key
runs no egress and none of this.
"""
from __future__ import annotations

import os
import shutil
import tempfile

import numpy as np
import torch

from portbench.reference import constants as C
from portbench.reference import fec, voice, walk_ref

# the columns a pass's listing adds to its summary, per carrier
LISTING = ("blocks", "frames", "bytes", "files")


def enabled(cfg: dict) -> bool:
    """Whether the configuration runs the egress: False without the key,
    True where it is true; any other value is refused."""
    if "egress" not in cfg:
        return False
    if cfg["egress"] is not True:
        raise ValueError(f"egress must be true, got {cfg['egress']!r}")
    return True


def make_dir() -> str:
    """A new empty dump directory under the process's TMPDIR."""
    return tempfile.mkdtemp(prefix="portbench-egress-")


def remove_dir(path: str) -> None:
    shutil.rmtree(path)


def _carrier_of(name: str) -> int | None:
    digits = name[len("carrier"):]
    if name.startswith("carrier") and digits.isdigit():
        return int(digits)
    return None


def contents(root: str) -> dict:
    """Every file the receiver wrote: {carrier: {name: bytes}}; a file
    or directory outside `carrier<i>/` goes under carrier -1."""
    out = {}
    for entry in os.scandir(root):
        c = _carrier_of(entry.name) if entry.is_dir() else None
        if c is None:
            out.setdefault(-1, {})[entry.name] = b""
            continue
        files = out.setdefault(c, {})
        for f in os.scandir(entry.path):
            with open(f.path, "rb") as fh:
                files[f.name] = fh.read()
    return out


def _count(name: str, size: int) -> tuple[int, int]:
    """(blocks, frames) a file of `size` bytes holds."""
    if name.endswith(".out"):
        return size // voice.OUT_BYTES, 0
    if name.endswith(".cod"):
        return 0, size // voice.COD_BYTES
    return 0, 0


def listing(root: str, n_car: int) -> np.ndarray:
    """A pass's directory by its listing, without reading a file: per
    carrier (LISTING) the blocks and voice frames its files hold, their
    bytes and their number [n_car + 1, 4]; the last row counts what lies
    outside the carriers' directories."""
    out = np.zeros((n_car + 1, len(LISTING)), np.int64)
    for entry in os.scandir(root):
        c = _carrier_of(entry.name) if entry.is_dir() else None
        if c is None or c >= n_car:
            out[n_car, 3] += 1
            continue
        for f in os.scandir(entry.path):
            size = f.stat().st_size
            out[c] += (*_count(f.name, size), size, 1)
    return out


def reference_slots(ref: dict, walks: dict, ks_path: str | None,
                    n_car: int) -> dict:
    """The traffic slots of every carrier, from the reference's walk
    (`walks` holds the carriers already walked; the rest are walked
    here): {carrier: [(slot j, NDB half, usage, timeslot, keystream)]}."""
    out = {}
    for c in range(n_car):
        if c not in walks:
            if not len(ref["slots"][c][1]):
                out[c] = []
                continue
            walks[c] = walk_ref.walk_carrier(
                ref["burst"][c], ref["emit"][c], ref["slots"][c][2],
                ref["slots"][c][1], ks_path, traffic=True)
        out[c] = walks[c]["traffic"]
    return out


def type4_rows(ref: dict, traffic: dict) -> dict:
    """Each traffic slot's type-4 bits, descrambled from the reference's
    own hard bits with its slot's scrambling code: the whole 432-bit
    block of a traffic slot, or an NDB slot's second half (216 bits,
    with the keystream from its start, as the port's `t4_b2`). Returns
    {(carrier, j): bits} as int8 tensors."""
    stream, carriers = ref["stream"], range(len(ref["slot_pos"]))
    counts = [len(ref["slot_pos"][c]) for c in carriers]
    want = [(c, j, half) for c, slots in traffic.items()
            for j, half, *_ in slots]
    out = {}
    if not want:
        return out
    # every emitted slot in carrier order, as the reference's decode
    # takes them, for each slot's scrambling code
    car = np.repeat(np.arange(len(counts), dtype=np.int64), counts)
    pos = np.concatenate([ref["slot_pos"][c] for c in carriers])
    kind = np.concatenate([ref["slots"][c][1] for c in carriers])
    codes = fec.slot_codes(fec.slot_bits(stream, car, pos), car, kind)[0]
    first = np.concatenate([[0], np.cumsum(counts)])
    at = np.asarray([first[c] + j for c, j, _ in want], np.int64)
    bits = fec.slot_bits(stream, car[at], pos[at]).to(torch.int8)
    b1 = bits[:, C.NDB_BLK1_OFFSET:C.NDB_BLK1_OFFSET + C.NDB_BLK_BITS]
    b2 = bits[:, C.NDB_BLK2_OFFSET:C.NDB_BLK2_OFFSET + C.NDB_BLK_BITS]
    code = codes[torch.as_tensor(at, device=codes.device)]
    full = torch.cat([b1, b2], dim=1) ^ fec.keystream(code, 432)
    second = b2 ^ fec.keystream(code, 216)
    for k, (c, j, half) in enumerate(want):
        out[c, j] = second[k] if half else full[k]
    return out


def expected_files(traffic: dict, rows: dict) -> dict:
    """What the reference says each carrier's directory holds: {carrier:
    {name: [record bytes]}}."""
    out = {c: {} for c in traffic}
    order = [(c, i) for c in traffic for i in range(len(traffic[c]))]
    blocks, frames = {}, {}
    for width in (432, 216):
        sel = [(c, i) for c, i in order
               if int(rows[c, traffic[c][i][0]].shape[0]) == width]
        if not sel:
            continue
        t4 = torch.stack([rows[c, traffic[c][i][0]] for c, i in sel])
        dumps = voice.dump_blocks(t4.cpu().numpy())
        for k, ci in enumerate(sel):
            blocks[ci] = dumps[k].tobytes()
        ks = np.zeros((len(sel), 274), np.uint8)
        for k, (c, i) in enumerate(sel):
            key = traffic[c][i][4]
            if key is not None:
                ks[k] = np.asarray(key, np.uint8)[:274]
        cod = voice.cod_frames(t4, ks)
        for k, ci in enumerate(sel):
            frames[ci] = cod[k].tobytes()
    for c, i in order:
        _, _, usage, tn, _ = traffic[c][i]
        stem = f"traffic_{usage}_{tn}"
        named = out[c]
        named.setdefault(stem + ".out", []).append(blocks[c, i])
        named.setdefault(stem + ".txt", []).append(voice.TXT_LINE)
        named.setdefault(f"voice_{usage}_{tn}.cod", []).append(frames[c, i])
    return out


def _record_size(name: str) -> int | None:
    for suffix, size in ((".out", voice.OUT_BYTES),
                         (".txt", len(voice.TXT_LINE)),
                         (".cod", voice.COD_BYTES)):
        if name.endswith(suffix):
            return size
    return None


def records_differing(name: str, got: bytes | None, want: list) -> int:
    """Records of one file that differ from the reference's, in order,
    plus those one side alone has (a trailing partial record counts as
    one); a file of a kind the reference does not write counts as one."""
    size = _record_size(name)
    if size is None:
        return 1 if got is not None else 0
    got = got or b""
    recs = [got[i:i + size] for i in range(0, len(got), size)]
    n = abs(len(recs) - len(want))
    for a, b in zip(recs, want):
        n += a != b
    return n


def evaluate(ref: dict, got: dict, walks: dict, ks_path: str | None,
             n_car: int) -> tuple[dict, dict]:
    """The check pass's directory (`contents`) against the reference:
    ({'dumps_differing', 'voice_differing'}, what was compared).
    dumps_differing: the `.out` blocks and `.txt` lines that differ from
    the reference's or that one side alone has, on every carrier, by
    file (usage and timeslot) and in slot order, plus every file or
    directory the reference does not write; voice_differing: the same of
    the `.cod` frames, TEA1 frames with the reference walk's keystream."""
    traffic = reference_slots(ref, walks, ks_path, n_car)
    want = expected_files(traffic, type4_rows(ref, traffic))
    dumps = voice_n = 0
    for c in set(want) | set(got):
        if c not in want:
            dumps += max(1, len(got[c]))
            continue
        have = got.get(c, {})
        for name in set(want[c]) | set(have):
            n = records_differing(name, have.get(name), want[c].get(name, []))
            if name.endswith(".cod"):
                voice_n += n
            else:
                dumps += n
    n_slots = sum(len(slots) for slots in traffic.values())
    compared = {
        "dump_blocks": n_slots, "voice_frames": n_slots,
        "voice_frames_keyed": sum(t[4] is not None for slots in
                                  traffic.values() for t in slots),
        "bytes_written": sum(len(d) for named in got.values()
                             for d in named.values())}
    return {"dumps_differing": dumps, "voice_differing": voice_n}, compared
