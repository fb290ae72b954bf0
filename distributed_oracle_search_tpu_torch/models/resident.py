"""Compressed-resident CPD shards: pack4/rle rows in device memory.

Port of the JAX package's ``models/resident.py``. A worker's resident
first-move table is ``[R, N]`` int8; the two codecs here keep it smaller
on the card and inflate rows only at the point of use. Selected by
``DOS_CPD_RESIDENT`` (``utils.env``; default ``raw``):

``pack4``
    Two first-move slots per byte: slots 0..13 pack into a nibble, 15 is
    the ``-1`` "no move" marker. There is no escape list — a resident row
    must be addressable without a scatter pass — so the codec applies
    only when every entry is < 14 (max out-degree <= 14, which covers
    road networks). Fixed 2x ratio. The walk kernel reads the packed rows
    directly (``ops.cuda_walk`` ``packed4=True``): raw rows never exist
    on the card.

``rle``
    Run-length over the TARGET axis, in row groups of ``group`` rows
    (``DOS_CPD_RLE_GROUP``, default 4096): within a group each source
    column's runs break at the column and group boundaries, so a run
    start fits uint16 and ``offsets[g * N + s]`` bounds the runs of one
    (group, column) cell. Layout: ``vals`` int8 [T], ``starts`` uint16
    [T], ``offsets`` int32 [n_groups * N + 1]. A row decodes by a
    static-depth, branch-free binary search per (row, source) over its
    cell's run starts.

``auto``
    The smaller viable codec (ties prefer ``rle``); neither viable
    degrades to ``raw`` with a warning, never a fault.

The same encodings persist on disk: :func:`encode_block` wraps a block's
encoded arrays in a self-describing uint8 container written through the
ordinary atomic ``.npy`` machinery. Containers are byte-identical to the
JAX package's (the json header keeps its key order and separators), so
both packages' crc32 digests agree and either loads the other's index.

The host encoders are numpy copies of the JAX package's; the device
decoders are plain torch (they were XLA, not Pallas, in the JAX package).
The JAX package's obs counters have no counterpart here.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from ..utils.env import env_cast, env_str
from ..utils.log import get_logger

log = get_logger(__name__)

#: accepted DOS_CPD_RESIDENT spellings; anything else degrades to raw
RESIDENT_CODECS = ("raw", "pack4", "rle", "auto")

#: nibble vocabulary of the streamed wire format: slots 0..13 pack
#: directly, 15 is the -1 marker. The resident codec has no 0xE escape
#: list — it requires every slot < 14 instead.
PACK4_ESCAPE = 14
PACK4_MARKER = 15

#: rle is viable only when resident bytes come in under this fraction of
#: the raw table
RESIDENT_RLE_MAX_FRAC = 0.9

#: default rows per rle row group; run starts are uint16 so the group is
#: capped at 65536 rows
_RLE_GROUP_DEFAULT = 4096

#: cells a device decoder holds at once: the rle bisection keeps int32
#: ``lo``/``hi``/``mid`` per cell, so one row chunk costs ~12 B a cell
#: (~0.8 GB here) however many rows the batch asks for
DECODE_CELLS = 1 << 26


def resident_choice() -> str:
    """The raw ``DOS_CPD_RESIDENT`` knob: ``raw`` / ``pack4`` / ``rle``
    / ``auto``; malformed values degrade to ``raw`` with a log line."""
    raw = (env_str("DOS_CPD_RESIDENT", "raw") or "raw").strip().lower()
    if raw not in RESIDENT_CODECS:
        log.warning("ignoring malformed DOS_CPD_RESIDENT=%r (using "
                    "'raw'; valid: %s)", raw, "/".join(RESIDENT_CODECS))
        return "raw"
    return raw


def rle_group_rows() -> int:
    """``DOS_CPD_RLE_GROUP``: rows per rle row group, clamped to
    [2, 65536] (run starts are uint16)."""
    g = env_cast("DOS_CPD_RLE_GROUP", _RLE_GROUP_DEFAULT, int)
    if g < 2 or g > 65536:
        log.warning("DOS_CPD_RLE_GROUP=%d out of [2, 65536]; using %d",
                    g, _RLE_GROUP_DEFAULT)
        g = _RLE_GROUP_DEFAULT
    return g


# -------------------------------------------------------------- encoders

def encode_pack4(fm: np.ndarray) -> np.ndarray | None:
    """[R, N] int8 fm -> [R, ceil(N/2)] uint8 nibble pairs (an odd N is
    padded with a marker nibble), or None when any entry >= 14."""
    fm = np.asarray(fm, np.int8)
    if fm.ndim != 2 or fm.size == 0:
        return None
    if int(fm.max(initial=-1)) >= PACK4_ESCAPE:
        return None
    a = np.where(fm < 0, np.uint8(PACK4_MARKER), fm.astype(np.uint8))
    if a.shape[1] % 2:
        a = np.concatenate(
            [a, np.full((a.shape[0], 1), np.uint8(PACK4_MARKER))],
            axis=1)
    return np.ascontiguousarray(a[:, 0::2] | (a[:, 1::2] << 4))


def encode_rle(fm: np.ndarray, group: int | None = None):
    """[R, N] int8 fm -> ``(starts u16 [T], vals i8 [T],
    offsets i32 [n_groups * N + 1], group)`` in (group, column)-major
    run order, or None when the encoding would not beat
    ``RESIDENT_RLE_MAX_FRAC`` of the raw bytes."""
    fm = np.asarray(fm, np.int8)
    if fm.ndim != 2 or fm.shape[0] < 2 or fm.shape[1] == 0:
        return None
    r, n = fm.shape
    group = rle_group_rows() if group is None else int(group)
    group = min(group, 65536)
    n_groups = -(-r // group)
    # cheap reject before the per-group transposes: the row-to-row
    # change count bounds the run count from below
    runs_min = int(np.count_nonzero(fm[1:] != fm[:-1])) + n
    if 3 * runs_min >= RESIDENT_RLE_MAX_FRAC * fm.nbytes:
        return None
    starts_l, vals_l, counts_l = [], [], []
    for gi in range(n_groups):
        a = np.ascontiguousarray(fm[gi * group:(gi + 1) * group].T)
        gg = a.shape[1]                                     # [N, gg]
        ch = np.empty((n, gg), bool)
        ch[:, 0] = True
        ch[:, 1:] = a[:, 1:] != a[:, :-1]
        idx = np.flatnonzero(ch.reshape(-1))
        starts_l.append((idx % gg).astype(np.uint16))
        vals_l.append(a.reshape(-1)[idx])
        counts_l.append(np.bincount(idx // gg,
                                    minlength=n).astype(np.int64))
    starts = np.concatenate(starts_l)
    vals = np.concatenate(vals_l)
    offsets64 = np.zeros(n_groups * n + 1, np.int64)
    np.cumsum(np.concatenate(counts_l), out=offsets64[1:])
    if offsets64[-1] >= 2**31:
        return None                       # int32 offsets would wrap
    offsets = offsets64.astype(np.int32)
    nbytes = starts.nbytes + vals.nbytes + offsets.nbytes
    if nbytes >= RESIDENT_RLE_MAX_FRAC * fm.nbytes:
        return None
    return starts, vals, offsets, group


def _rle_steps(offsets: np.ndarray) -> int:
    """Static binary-search depth: ceil(log2(max runs per cell))."""
    cnt = int(np.max(np.diff(np.asarray(offsets, np.int64)),
                     initial=1))
    return max(int(max(cnt - 1, 1)).bit_length(), 1)


# ------------------------------------------------------ device decoders

def _row_chunks(c: int, n: int):
    """Slices of at most ``DECODE_CELLS // n`` rows covering ``c``."""
    step = max(1, DECODE_CELLS // max(n, 1))
    return (slice(i, min(i + step, c)) for i in range(0, c, step))


def decode_pack4_rows(packed: torch.Tensor, rows: torch.Tensor,
                      n: int) -> torch.Tensor:
    """Gather + nibble-unpack the named rows: [C] row ids -> [C, N] int8
    fm (15 -> -1). Pad/negative row ids clamp to row 0 — their lanes are
    valid=False and never read."""
    r = packed.shape[0]
    rows = rows.long().clamp(0, r - 1)
    out = torch.empty((rows.shape[0], n), dtype=torch.int8,
                      device=packed.device)
    for sl in _row_chunks(rows.shape[0], n):
        pk = packed[rows[sl]]                               # [c, W2]
        v = torch.stack([pk & 0xF, pk >> 4], dim=-1).reshape(
            pk.shape[0], -1)[:, :n]
        out[sl] = torch.where(v == PACK4_MARKER, -1, v.to(torch.int8))
    return out


def decode_rle_rows(starts: torch.Tensor, vals: torch.Tensor,
                    offsets: torch.Tensor, rows: torch.Tensor, n: int,
                    group: int, steps: int, r: int) -> torch.Tensor:
    """Run-start search decode: [C] row ids -> [C, N] int8 fm.

    For row ``row`` and source ``s`` the answer is the value of the run
    covering in-group position ``row % group`` within cell
    ``(row // group, s)`` — a branch-free binary search over the cell's
    run range (``offsets`` bounds it; ``steps`` = static
    ``ceil(log2(max cell runs))``). Every cell holds >= 1 run whose start
    is 0, so ``starts[lo] <= j`` holds from the first step. The row set
    decodes in chunks of rows, so the per-cell temporaries stay bounded
    by ``DECODE_CELLS``."""
    rows = rows.long().clamp(0, r - 1)
    st32 = starts.to(torch.int32) & 0xFFFF      # uint16 bits held as int16
    cols = torch.arange(n, dtype=torch.int64, device=rows.device)
    out = torch.empty((rows.shape[0], n), dtype=torch.int8,
                      device=rows.device)
    for sl in _row_chunks(rows.shape[0], n):
        rr = rows[sl]
        j = (rr % group).to(torch.int32)[:, None]           # [c, 1]
        cell = (rr // group)[:, None] * n + cols[None, :]   # [c, N]
        lo = offsets[cell]
        hi = offsets[cell + 1]
        del cell
        # branch-free bisection:
        #   starts[mid] <= j  -> answer in [mid, hi)
        #   otherwise         -> answer in [lo, mid)
        for _ in range(max(steps, 1)):
            narrow = hi - lo > 1
            mid = (lo + hi) // 2
            right = (st32[mid] <= j) & narrow
            lo = torch.where(right, mid, lo)
            hi = torch.where(narrow & ~right, mid, hi)
        out[sl] = vals[lo]
    return out


class CompressedFM:
    """A compressed-resident first-move shard: the codec, the logical
    ``(R, N)`` shape, and the device-resident encoded arrays.

    Quacks enough like the raw ``[R, N]`` table for the engine's shape
    checks (``shape``, ``nbytes``); :meth:`decompress_rows` inflates an
    arbitrary row set to a dense ``[C, N]`` int8 block."""

    def __init__(self, codec: str, shape: tuple[int, int],
                 arrays: dict, group: int = 0, steps: int = 0):
        self.codec = codec
        self.shape = tuple(shape)
        self.arrays = arrays
        self.group = int(group)
        self.steps = int(steps)

    @property
    def nbytes(self) -> int:
        return int(sum(a.numel() * a.element_size()
                       for a in self.arrays.values()))

    @property
    def packed(self) -> torch.Tensor:
        """The pack4 nibble array — what the pack4 walk reads directly."""
        return self.arrays["packed"]

    def decompress_rows(self, rows: torch.Tensor) -> torch.Tensor:
        """Inflate the named rows to a dense [C, N] int8 block on the
        arrays' device; bit-identical to the raw table's ``fm[rows]``."""
        if self.codec == "pack4":
            return decode_pack4_rows(self.arrays["packed"], rows,
                                     n=self.shape[1])
        return decode_rle_rows(
            self.arrays["starts"], self.arrays["vals"],
            self.arrays["offsets"], rows, n=self.shape[1],
            group=self.group, steps=self.steps, r=self.shape[0])


def _pick_auto(rle, p4):
    """``auto``: the smaller wins, ties prefer rle (it keeps shrinking
    with run coherence; pack4 is a fixed 2x). Returns ``(rle, p4)`` with
    the loser dropped; a lone candidate passes through."""
    if rle is not None and p4 is not None:
        if sum(int(a.nbytes) for a in rle[:3]) > p4.nbytes:
            return None, p4
        return rle, None
    return rle, p4


def make_resident(rows: np.ndarray, codec: str | None = None,
                  device: torch.device | str = "cuda"):
    """Materialize one shard's resident first-move table under the
    ``DOS_CPD_RESIDENT`` policy (an explicit ``codec`` wins) on
    ``device``.

    Returns ``(table, codec_used)`` — ``table`` is the raw int8 tensor
    for ``raw``, a :class:`CompressedFM` otherwise. A requested codec
    that is not viable DEGRADES to raw with a warning, never a fault."""
    req = resident_choice() if codec is None else str(codec)
    if req not in RESIDENT_CODECS:
        raise ValueError(f"unknown resident codec {req!r}")
    rows = np.asarray(rows, np.int8)

    def place(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    if req == "raw":
        return place(rows), "raw"
    rle, p4 = _pick_auto(
        encode_rle(rows) if req in ("rle", "auto") else None,
        encode_pack4(rows) if req in ("pack4", "auto") else None)
    if rle is not None:
        starts, vals, offsets, group = rle
        fm = CompressedFM(
            "rle", rows.shape,
            {"starts": place(starts.view(np.int16)),
             "vals": place(vals), "offsets": place(offsets)},
            group=group, steps=_rle_steps(offsets))
    elif p4 is not None:
        fm = CompressedFM("pack4", rows.shape, {"packed": place(p4)})
    else:
        log.warning("DOS_CPD_RESIDENT=%s not viable for this %dx%d "
                    "shard (escape slots / incompressible runs); "
                    "serving raw", req, *rows.shape)
        return place(rows), "raw"
    log.info("resident %s: %dx%d fm %.1f MB -> %.1f MB (%.1fx)",
             fm.codec, rows.shape[0], rows.shape[1],
             rows.nbytes / 2**20, fm.nbytes / 2**20,
             rows.nbytes / max(fm.nbytes, 1))
    return fm, fm.codec


# --------------------------------------------------- on-disk containers
#
# A compressed block file is an ordinary .npy holding a self-describing
# 1-D uint8 container: magic + json header + the encoded arrays' raw
# bytes. Raw blocks are 2-D int8, containers 1-D uint8 with a magic
# prefix: the two can never be confused.

BLOCK_MAGIC = b"DOSCPDC1"


def is_container(arr) -> bool:
    """Is this loaded block array a compressed container (vs raw 2-D
    int8 fm rows)?"""
    try:
        return (arr.ndim == 1 and arr.dtype == np.uint8
                and arr.shape[0] > len(BLOCK_MAGIC) + 4
                and bytes(np.asarray(arr[:len(BLOCK_MAGIC)]))
                == BLOCK_MAGIC)
    except (AttributeError, TypeError):
        return False


def _container_header(arr) -> tuple[dict, int]:
    """Parse a container's json header; returns (header, body offset).
    Raises ValueError on a torn/foreign payload. Reads only the magic +
    header slice, so an mmap'd block is not materialized."""
    if not is_container(arr):
        raise ValueError("not a compressed CPD block container")
    hl_off = len(BLOCK_MAGIC)
    hlen = int.from_bytes(
        bytes(np.asarray(arr[hl_off:hl_off + 4], np.uint8)), "little")
    body = hl_off + 4 + hlen
    if hlen <= 0 or body > arr.shape[0]:
        raise ValueError("compressed block header length out of range")
    try:
        header = json.loads(bytes(
            np.asarray(arr[hl_off + 4:body], np.uint8)).decode())
    except (UnicodeDecodeError, ValueError) as e:
        raise ValueError(f"compressed block header unparsable: {e}")
    return header, body


def block_codec(arr) -> str | None:
    """Codec recorded in a container block (None for raw blocks)."""
    if not is_container(arr):
        return None
    header, _ = _container_header(arr)
    return str(header.get("codec"))


def encode_block(rows: np.ndarray, codec: str | None):
    """Encode one block's raw rows for persistence. Returns
    ``(payload uint8 [nbytes], codec_used)`` or None when the block
    should be written raw (codec None/raw, or not viable for these rows —
    each block degrades independently, the manifest records what
    happened)."""
    if codec in (None, "raw"):
        return None
    rows = np.asarray(rows, np.int8)
    # key order and json.dumps' default separators are part of the
    # format: the JAX package writes the same bytes, so digests agree
    header: dict = {"codec": None, "shape": list(rows.shape)}
    rle, p4 = _pick_auto(
        encode_rle(rows) if codec in ("rle", "auto") else None,
        encode_pack4(rows) if codec in ("pack4", "auto") else None)
    if rle is not None:
        starts, vals, offsets, group = rle
        header.update(codec="rle", group=group)
        arrays = [("starts", starts), ("vals", vals),
                  ("offsets", offsets)]
    elif p4 is not None:
        header["codec"] = "pack4"
        arrays = [("packed", p4)]
    else:
        return None
    header["arrays"] = [[name, str(a.dtype), list(a.shape)]
                        for name, a in arrays]
    hb = json.dumps(header).encode()
    payload = b"".join([BLOCK_MAGIC, len(hb).to_bytes(4, "little"), hb]
                       + [np.ascontiguousarray(a).tobytes()
                          for _, a in arrays])
    return np.frombuffer(payload, np.uint8).copy(), header["codec"]


def decode_block_rows(arr) -> np.ndarray:
    """Container payload -> the raw [C, N] int8 rows it encodes
    (host-side; bit-identical to what was encoded). Raises ValueError on
    a torn/foreign payload — callers treat that as a corrupt block."""
    header, off = _container_header(arr)
    got: dict[str, np.ndarray] = {}
    for name, dtype, shape in header.get("arrays", []):
        size = int(np.prod(shape, dtype=np.int64)) * np.dtype(dtype).itemsize
        if off + size > arr.shape[0]:
            raise ValueError(f"compressed block truncated at {name!r}")
        got[name] = np.frombuffer(
            bytes(np.asarray(arr[off:off + size], np.uint8)),
            dtype).reshape(shape)
        off += size
    r, n = (int(x) for x in header["shape"])
    codec = header.get("codec")
    if codec == "pack4":
        packed = got["packed"]
        lo = (packed & 0xF).astype(np.int8)
        hi = ((packed >> 4) & 0xF).astype(np.int8)
        v = np.stack([lo, hi], axis=-1).reshape(r, -1)[:, :n]
        return np.where(v == PACK4_MARKER, np.int8(-1), v)
    if codec != "rle":
        raise ValueError(f"unknown compressed block codec {codec!r}")
    starts = got["starts"].astype(np.int64)
    vals, offsets = got["vals"], got["offsets"].astype(np.int64)
    group = int(header["group"])
    n_groups = -(-r // group)
    out = np.empty((r, n), np.int8)
    for gi in range(n_groups):
        gg = min(group, r - gi * group)
        o0, o1 = int(offsets[gi * n]), int(offsets[(gi + 1) * n])
        st = starts[o0:o1]
        ends = np.empty(o1 - o0, np.int64)
        ends[:-1] = st[1:]
        ends[-1] = gg
        # the last run of each CELL ends at the group height, not at the
        # next cell's (restarted) first start
        cell_last = offsets[gi * n + 1:(gi + 1) * n + 1] - 1 - o0
        ends[cell_last] = gg
        col = np.repeat(vals[o0:o1], ends - st)       # [N * gg]
        out[gi * group:gi * group + gg] = col.reshape(n, gg).T
    return out


def maybe_decode_rows(arr) -> np.ndarray:
    """Raw rows pass through; container payloads decode. The one call
    every consumer that needs dense rows makes after loading a block."""
    a = np.asarray(arr)
    if is_container(a):
        return decode_block_rows(a)
    return a
