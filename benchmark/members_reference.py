"""The plain reference for a multi-member gzip file whose members are the
fixed-size shards of one source, in source order (RFC 1952 section 2.2, as
pigz and BGZF write them). It imports nothing of the program, of JAX or of
the JAX package.

The file is walked by RFC 1952 alone, with Python's zlib (wbits=31: a gzip
member, whose trailer zlib checks against what it decoded) and its
unused_data: the members' offsets are found in the file, never taken from
the program's info. Member k must hold source bytes [k*shard, min((k+1) *
shard, n)): it decodes to exactly those bytes, its trailer's CRC-32 and
ISIZE are those worked out again from them, and the members tile the file
with nothing before, between or after them. Then info["members"][k]'s
offset, length and input size must agree with the walk.

Every check counts faults; a sound file counts none.
"""
from __future__ import annotations

import zlib

from . import reference

FEED = 1 << 18          # bytes handed to zlib at a time


class _Truncated(ValueError):
    """The file ends inside a member."""


def read_member(blob: memoryview, pos: int) -> tuple[bytes, int]:
    """The member that starts at byte `pos`: (its decoded bytes, the byte
    after its trailer). Raises zlib.error where it breaks RFC 1951 or 1952
    or its trailer disagrees with what it decodes to, _Truncated where the
    file ends inside it."""
    d = zlib.decompressobj(31)
    out = []
    p = pos
    while not d.eof:
        if p >= len(blob):
            raise _Truncated(f"the file ends inside the member at {pos}")
        piece = blob[p:p + FEED]
        out.append(d.decompress(piece))
        p += len(piece)
    return b"".join(out), p - len(d.unused_data)


def walk(blob: bytes) -> tuple[list, str]:
    """Every member the file holds, in file order: [(offset, length,
    decoded bytes)], and "" or the fault that stopped the walk (a member
    that does not decode, bytes after the last member that are no member)."""
    mv = memoryview(blob)
    members, pos = [], 0
    while pos < len(blob):
        try:
            out, end = read_member(mv, pos)
        except (zlib.error, _Truncated) as e:
            return members, f"byte {pos}: {e}"
        members.append((pos, end - pos, out))
        pos = end
    return members, ""


def check_members(blob: bytes, payload: bytes, shard: int,
                  info: dict | None = None) -> dict:
    """A multi-member gzip file against the source it shards. Returns
    {"rejected": member slots that are missing, extra, undecodable or whose
    trailer is not their shard's, "differing": bytes that differ from the
    source, slot by slot, "info_faults": a line for each way info disagrees
    with the walk, "members": [(offset, length)] of the members found}."""
    n = len(payload)
    want = max(1, -(-n // shard))
    found, stopped = walk(blob)
    rejected = differing = 0
    for k in range(max(want, len(found))):
        if k >= want:
            rejected += 1               # a member past the last shard
            differing += len(found[k][2])
            continue
        src = payload[k * shard:min((k + 1) * shard, n)]
        if k >= len(found):
            rejected += 1               # missing
            differing += len(src)
            continue
        off, ln, out = found[k]
        trailer = blob[off + ln - 8:off + ln]
        crc = int.from_bytes(trailer[:4], "little")
        isize = int.from_bytes(trailer[4:], "little")
        rejected += int(crc != zlib.crc32(src)
                        or isize != len(src) & 0xFFFFFFFF)
        differing += reference.bytes_differing(out, src)
    if stopped:
        rejected += 1                   # what follows is not a member
    faults = []
    if info is not None:
        faults = info_faults(info, [(o, ln, len(out)) for o, ln, out in found],
                             n, want)
    return {"rejected": rejected, "differing": differing,
            "info_faults": faults,
            "members": [(o, ln) for o, ln, _ in found]}


def info_faults(info: dict, found: list, n: int, want: int) -> list:
    """Where the program's info disagrees with the members the walk found,
    [(offset, length, decoded size)]: its mode and n, its member count, and
    each member's offset, length and input size."""
    faults = []
    if info.get("mode") != "members" or info.get("n") != n:
        faults.append(f"info mode {info.get('mode')!r}, n {info.get('n')} "
                      f"for members of {n} bytes")
    listed = info.get("members") or []
    if len(listed) != want:
        faults.append(f"info lists {len(listed)} members for {want} shards")
    for k, (m, f) in enumerate(zip(listed, found)):
        if tuple(m[:3]) != f:
            faults.append(f"member {k}: info (offset, length, size) "
                          f"{tuple(m[:3])}, the file {f}")
    return faults
