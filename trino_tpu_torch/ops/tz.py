"""Time-zone database and device functions for TIMESTAMP WITH TIME ZONE.

Counterpart of trino_tpu/ops/tz.py (TimeZoneKey.java's zone registry,
DateTimeEncoding.java's short packing, DateTimes.java's offset math).

One int64 column per value, packed as instant millis << 12 | zone id:
the instant sits in the high bits, so plain int64 order is instant
order first. Comparisons strip the zone bits (`>> 12`, an arithmetic
shift: instants before 1970 are negative) and the key paths key on a
zone-masked copy (sql/optimizer.py::canonicalize_tstz_keys).

The registry is deterministic and follows the host's TZif files: UTC is
0; fixed offsets of -14:00..+14:00 map minutes -840..840 onto ids
1..1681; the IANA names, sorted, start at 1800. Rules parse from the
TZif files (RFC 8536) and are cached per zone.

Device functions are torch ops (an XLA formulation in the reference, no
Pallas kernel): `offset_millis_at` is one `torch.searchsorted` over a
zone's transitions. The per-row-zone forms search one flat array that
holds every zone's transitions back to back, each row within its own
zone's [start, start + length) slice, in log2(longest zone) steps of
vectorized gathers. The reference gathers a whole (zones x longest)
matrix row per input row instead (about 5 KB of temporaries a row); the
answers are bit-equal, including its clip of out-of-range zone ids.
"""

from __future__ import annotations

import functools
import os
import struct
from typing import Optional, Tuple

import numpy as np
import torch

MILLIS_SHIFT = 12
ZONE_MASK = (1 << MILLIS_SHIFT) - 1

_FIXED_BASE = 841  # id = _FIXED_BASE + offset_minutes (-840..840 -> 1..1681)
_NAMED_BASE = 1800

UTC_ID = 0


@functools.lru_cache(maxsize=1)
def _named_zones() -> Tuple[str, ...]:
    import zoneinfo

    return tuple(sorted(zoneinfo.available_timezones()))


@functools.lru_cache(maxsize=1)
def _named_index() -> dict:
    return {n: i for i, n in enumerate(_named_zones())}


def zone_id(name: str) -> int:
    """Zone name -> 12-bit key. Raises ValueError for unknown zones."""
    s = name.strip()
    if s.upper() in ("UTC", "Z", "GMT", "UT", "+00:00", "-00:00"):
        return UTC_ID
    if s and s[0] in "+-":
        sign = -1 if s[0] == "-" else 1
        body = s[1:]
        if ":" in body:
            hh, mm = body.split(":", 1)
        elif len(body) == 4:
            hh, mm = body[:2], body[2:]
        else:
            hh, mm = body, "0"
        minutes = sign * (int(hh) * 60 + int(mm))
        if not -840 <= minutes <= 840:
            raise ValueError(f"zone offset out of range: {name!r}")
        return _FIXED_BASE + minutes
    idx = _named_index().get(s)
    if idx is None:
        raise ValueError(f"unknown time zone: {name!r}")
    return _NAMED_BASE + idx


def zone_name(zid: int) -> str:
    if zid == UTC_ID:
        return "UTC"
    if _FIXED_BASE - 840 <= zid <= _FIXED_BASE + 840:
        minutes = zid - _FIXED_BASE
        sign = "-" if minutes < 0 else "+"
        m = abs(minutes)
        return f"{sign}{m // 60:02d}:{m % 60:02d}"
    names = _named_zones()
    idx = zid - _NAMED_BASE
    if 0 <= idx < len(names):
        return names[idx]
    raise ValueError(f"unknown zone id: {zid}")


# ---------------------------------------------------------------------------
# TZif parsing (RFC 8536): transitions in UTC seconds, utoff per type
# ---------------------------------------------------------------------------


def _tzif_path(name: str) -> Optional[str]:
    import zoneinfo

    for root in zoneinfo.TZPATH:
        p = os.path.join(root, name)
        if os.path.isfile(p):
            return p
    try:  # the tzdata package, where the host has no zone files
        import importlib.resources as res

        pkg = "tzdata.zoneinfo." + ".".join(name.split("/")[:-1])
        fname = name.split("/")[-1]
        with res.as_file(res.files(pkg) / fname) as p:
            return str(p)
    except Exception:
        return None


def _parse_tzif(data: bytes):
    """-> (transitions_s int64[T], offsets_s int64[T+1]): offsets_s[i]
    applies before transitions_s[i]; offsets_s[-1] after the last."""

    def header(off):
        magic, ver = data[off: off + 4], data[off + 4: off + 5]
        if magic != b"TZif":
            raise ValueError("not a TZif file")
        counts = struct.unpack(">6I", data[off + 20: off + 44])
        return ver, counts  # isutcnt isstdcnt leapcnt timecnt typecnt charcnt

    ver, counts = header(0)
    isut, isstd, leap, timecnt, typecnt, charcnt = counts

    def size(tc, ty, ch, lp, istd, iut, w):
        return tc * w + tc + ty * 6 + ch + lp * (w + 4) + istd + iut

    off = 44
    width = 4
    if ver in (b"2", b"3", b"4"):
        # skip the v1 body, parse the 64-bit v2 body
        off += size(timecnt, typecnt, charcnt, leap, isstd, isut, 4)
        _, counts = header(off)
        isut, isstd, leap, timecnt, typecnt, charcnt = counts
        off += 44
        width = 8
    fmt = ">%d%s" % (timecnt, "q" if width == 8 else "l")
    trans = np.array(
        struct.unpack(fmt, data[off: off + timecnt * width]), dtype=np.int64
    )
    off += timecnt * width
    idx = np.frombuffer(data[off: off + timecnt], dtype=np.uint8)
    off += timecnt
    utoffs = np.empty(typecnt, dtype=np.int64)
    for t in range(typecnt):
        utoffs[t] = struct.unpack(">l", data[off + t * 6: off + t * 6 + 4])[0]
    # the offset before the first transition: the first non-DST type
    # (RFC 8536 §3.2), else type 0
    first = 0
    for t in range(typecnt):
        if not data[off + t * 6 + 4]:
            first = t
            break
    offsets = np.concatenate(
        [[utoffs[first]], utoffs[idx]] if timecnt else [[utoffs[first]]]
    ).astype(np.int64)
    return trans, offsets


@functools.lru_cache(maxsize=None)
def zone_rules(zid: int) -> Tuple[np.ndarray, np.ndarray]:
    """(transitions_s, offsets_s) of a zone id; fixed offsets have no
    transitions."""
    if zid == UTC_ID:
        return np.empty(0, dtype=np.int64), np.zeros(1, dtype=np.int64)
    if _FIXED_BASE - 840 <= zid <= _FIXED_BASE + 840:
        minutes = zid - _FIXED_BASE
        return np.empty(0, dtype=np.int64), np.array([minutes * 60], dtype=np.int64)
    name = zone_name(zid)
    path = _tzif_path(name)
    if path is None:
        raise ValueError(f"no TZif data for zone {name!r}")
    with open(path, "rb") as f:
        return _parse_tzif(f.read())


# ---------------------------------------------------------------------------
# Packing and device functions
# ---------------------------------------------------------------------------


def pack(millis, zid) -> torch.Tensor:
    """(instant millis, zone id) -> packed int64."""
    return (torch.as_tensor(millis, dtype=torch.int64) << MILLIS_SHIFT) | int(zid)


def unpack_millis(packed) -> torch.Tensor:
    return torch.as_tensor(packed) >> MILLIS_SHIFT


def unpack_zone(packed) -> torch.Tensor:
    return (torch.as_tensor(packed) & ZONE_MASK).to(torch.int32)


def pack_py(millis: int, zid: int) -> int:
    return (int(millis) << MILLIS_SHIFT) | int(zid)


@functools.lru_cache(maxsize=None)
def _rules_on(zid: int, device: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """A zone's transitions and offsets in ms, on one device."""
    trans, offs = zone_rules(zid)
    return (torch.from_numpy(trans * 1000).to(device),
            torch.from_numpy(offs * 1000).to(device))


def offset_millis_at(instant_ms, zid: int) -> torch.Tensor:
    """UTC offset (ms) of the static zone `zid` at each instant: one
    searchsorted over the zone's transitions."""
    inst = torch.as_tensor(instant_ms, dtype=torch.int64)
    trans, offs = zone_rules(zid)
    if len(trans) == 0:
        return torch.full_like(inst, int(offs[0]) * 1000)
    t, o = _rules_on(zid, str(inst.device))
    pos = torch.searchsorted(t, inst.contiguous(), right=True)
    return o[torch.clamp(pos, max=o.shape[0] - 1)]


@functools.lru_cache(maxsize=1)
def _zone_flat():
    """Every registry id's rules back to back: (transitions_ms,
    offsets_ms, start of each id's transitions, their count, start of
    its offsets). Ids of no zone (1682..1799) have none and offset 0, as
    the reference's zero-filled matrix rows."""
    n_ids = _NAMED_BASE + len(_named_zones())
    known = set([UTC_ID] + list(range(1, 1682))
                + [_NAMED_BASE + i for i in range(len(_named_zones()))])
    trans, offs = [], []
    starts = np.zeros(n_ids, dtype=np.int64)
    lens = np.zeros(n_ids, dtype=np.int64)
    ostarts = np.zeros(n_ids, dtype=np.int64)
    t_at = o_at = 0
    for z in range(n_ids):
        if z in known:
            t, o = zone_rules(z)
        else:
            t, o = np.empty(0, dtype=np.int64), np.zeros(1, dtype=np.int64)
        starts[z], lens[z], ostarts[z] = t_at, len(t), o_at
        trans.append(t * 1000)
        offs.append(o * 1000)
        t_at += len(t)
        o_at += len(o)
    return (np.concatenate(trans), np.concatenate(offs), starts, lens, ostarts)


@functools.lru_cache(maxsize=None)
def _flat_on(device: str):
    return tuple(torch.from_numpy(a).to(device) for a in _zone_flat())


def offset_millis_rowwise(instant_ms, zids) -> torch.Tensor:
    """UTC offset (ms) with a zone id per row. pos = #(transitions of the
    row's zone <= instant) by binary lifting over that zone's slice of
    the flat table, then the zone's offset at pos. Ids outside the
    registry clip to its ends, as the reference's."""
    inst = torch.as_tensor(instant_ms, dtype=torch.int64)
    flat_t, flat_o, starts, lens, ostarts = _flat_on(str(inst.device))
    z = torch.clamp(torch.as_tensor(zids).to(torch.int32), 0, starts.shape[0] - 1).to(torch.int64)
    lo, n = starts[z], lens[z]
    pos = torch.zeros_like(n)
    step = 1 << (max(int(_zone_flat()[3].max()), 1).bit_length() - 1)
    while step:
        cand = pos + step
        fits = cand <= n
        at = flat_t[torch.where(fits, lo + cand - 1, torch.zeros_like(lo))]
        pos = torch.where(fits & (at <= inst), cand, pos)
        step >>= 1
    return flat_o[ostarts[z] + pos]


def wall_to_instant_millis(wall_ms, zid: int) -> torch.Tensor:
    """Local wall-clock millis (read as if UTC) -> instant millis in zone
    `zid`: the offset at the wall time read as an instant, then again at
    the corrected instant, as the reference resolves it. A wall time in
    a gap takes the offset after the transition (Trino moves it forward
    instead); one in an overlap takes the first occurrence west of UTC
    and the second east of it (Trino: the first). ROADMAP §3."""
    wall_ms = torch.as_tensor(wall_ms, dtype=torch.int64)
    off1 = offset_millis_at(wall_ms, zid)
    off2 = offset_millis_at(wall_ms - off1, zid)
    return wall_ms - off2


def wall_to_instant_rowwise(wall_ms, zids) -> torch.Tensor:
    """wall_to_instant_millis with a zone id per row."""
    wall_ms = torch.as_tensor(wall_ms, dtype=torch.int64)
    off1 = offset_millis_rowwise(wall_ms, zids)
    off2 = offset_millis_rowwise(wall_ms - off1, zids)
    return wall_ms - off2


# -- host helpers (literals, formatting) --------------------------------------


def offset_millis_py(zid: int, instant_ms: int) -> int:
    trans, offs = zone_rules(zid)
    pos = int(np.searchsorted(trans, instant_ms // 1000, side="right"))
    return int(offs[pos]) * 1000


def format_tstz(packed: int) -> str:
    """Packed value -> 'YYYY-MM-DD HH:MM:SS.mmm Zone'."""
    import datetime as _dt

    ms = packed >> MILLIS_SHIFT
    zid = packed & ZONE_MASK
    off = offset_millis_py(zid, ms)
    local = _dt.datetime(1970, 1, 1) + _dt.timedelta(milliseconds=ms + off)
    return (
        f"{local.year:04d}-{local.month:02d}-{local.day:02d} "
        f"{local.hour:02d}:{local.minute:02d}:{local.second:02d}"
        f".{local.microsecond // 1000:03d} {zone_name(zid)}"
    )


def _split_zone(text: str) -> Tuple[str, Optional[int]]:
    """'body [Zone|+HH:MM|Z]' -> (body, zone id or None): the one
    trailing-zone scanner of literal_has_zone and parse_tstz."""
    s = text.strip()
    if s.endswith(("Z", "z")):
        return s[:-1], UTC_ID
    parts = s.rsplit(" ", 1)
    if len(parts) == 2:
        try:
            return parts[0], zone_id(parts[1])
        except ValueError:
            pass
    # an ISO offset glued to the time (the date's dashes sit before
    # index 10, which the range excludes)
    for i in range(len(s) - 1, max(len(s) - 7, 9), -1):
        if s[i] in "+-" and s[i - 1].isdigit():
            try:
                return s[:i], zone_id(s[i:])
            except ValueError:
                return s, None
    return s, None


def literal_has_zone(text: str) -> bool:
    """True when a timestamp literal names a zone (name, offset or Z):
    TIMESTAMP WITH TIME ZONE, not TIMESTAMP."""
    return _split_zone(text)[1] is not None


def parse_tstz(text: str, session_zone: str = "UTC") -> Optional[int]:
    """'2020-03-08 01:30:00[.fff] [Zone|+HH:MM]' -> packed int64, None if
    it does not parse. A string without a zone takes the session's."""
    import datetime as _dt

    s, zone = _split_zone(text)
    if zone is None:
        zone = zone_id(session_zone)
    try:
        dt = _dt.datetime.fromisoformat(s.strip().replace("T", " "))
    except ValueError:
        return None
    wall_ms = ((dt - _dt.datetime(1970, 1, 1)) // _dt.timedelta(microseconds=1)) // 1000
    off1 = offset_millis_py(zone, wall_ms)
    off2 = offset_millis_py(zone, wall_ms - off1)
    return pack_py(wall_ms - off2, zone)
