"""Data-parallel sharded compression over a mesh of devices.

The input splits into shards of blocks_per_device x block_size bytes; each
round gives rank k of the mesh shard k, and every rank runs the whole
block-batch encode (codec.deflate.encode_batch) on its shard on its own
device, with no traffic between ranks while it computes (the DEFLATE window
bound makes shards independent). Every rank's encode and crc32 is launched
before anything is read back, so ranks on different cards overlap, and
AHEAD more rounds are launched before a round is read, so the cards work
on them while the host reads, indexes and assembles. What the JAX package
does with collectives the host does here:

  (a) each shard's compressed bit length is read back with its meta (the
      all-gather of the lengths);
  (b) members are laid out in rank order (the exclusive scan of lengths);
  (c) each shard's produced words are read back and concatenated;
  (d) the shards' crc32s, computed on their ranks' devices, are combined
      with the GF(2) algebra (ops.checksum.crc32_combine; the reference's
      crc32_ncombine, src/zstrm.c:1427-1443). The gzip trailer takes the
      crc32 only, so no adler32 is computed.

A mesh may span the processes of a torch.distributed group (ProcessMesh):
each process then encodes and reads back its own ranks' shards, and one
all_gather_object over the group, after the last round, gives every
process every shard's bytes, crc32 and index, in the manner of the
reference's process_allgather of members (scripts/multiproc_smoke.py);
(b) and (d) then run in every process. One process is the group-of-one
case of the same loop.

Tracing (trace.py): compress is the request "ShardedDeflater.compress",
its body the span "shard". Each round is four spans: shard.upload (the
shard buffers filled and sent up), shard.launch (every rank's encode and
crc32), shard.read (every rank's crc32 and read_batch read back: blocking
reads, which wait for the round's work on the rank's card),
shard.assemble (the member bytes, the fault hook and verify, the index
entries; and _assemble once after the last round); shard.gather is the
group's gather. Counters: shard.rounds,
shard.members (0 in stream mode), shard.ranks (this process's ranks that
encoded a shard in the call) and shard.retries. The batches' own counters
(encode.match_ns, encode.launch_wait_ns, encode.code_ns, encode.entropy_ns,
encode.match_kernel, encode.ext_kernel, encode.tree_kernel,
encode.scan_kernel, crc32.kernel, d2h.calls, program.nodes) join the
same record, so trace.last_request() after a call shows what it did on
every card.

Two output modes:
  members: each shard becomes a complete gzip member; the concatenated
    members are a valid multi-member gzip file (RFC 1952 §2.2), and decode
    is parallel over members too (decompress_members).
  stream: one deflate stream; shard k sees the 32 KiB before it as a
    preset-dictionary halo (a better ratio; shards join at sync-flush
    seams).
"""
from __future__ import annotations

import collections
import zlib

import numpy as np
import torch
import torch.distributed as dist

from .. import trace
from ..codec import deflate as De
from ..codec import levels
from ..codec.inflate import RawInflater
from ..formats import headers as H
from ..ops import checksum as cs
from ..stream import host_inflate as hi
from ..stream import native, zstrm
from ..utils import device as _device
from ..utils import errors
from .mesh import ProcessMesh, make_mesh, spanning

HALO = De.HALO
PAD = De.PAD
# rounds launched past the one being read: the host's reads, index entries
# and assembly of a round (about as long as a card's encode of a 1 MiB
# shard at level 6) then run while the cards encode the next rounds
AHEAD = 2


def encode_sharded(data_sh, shard_lens, dict_lens, final_blocks, bl: int,
                   bpd: int, level: int, num_words: int) -> list:
    """Encode every rank's shard on the rank's device.

    data_sh: per rank, a (HALO + bpd*bl + PAD,) uint8 tensor on its device
      (None for an empty shard); shard_lens, dict_lens, final_blocks: per
      rank ints (final_blocks: the index of the BFINAL block, or -1).
    Returns per rank the batch_handle of its encode_batch result on its
    device (None for an empty shard, which launches nothing): the replayed
    program of its shape on a card, one per device, which ranks on one
    card share. Nothing is read back.
    """
    return [De.launch_batch(d, 0, n, dl, fin, bl, bpd, level, num_words)
            if n else None
            for d, n, dl, fin in zip(data_sh, shard_lens, dict_lens,
                                     final_blocks)]


def checksums_sharded(data_sh, shard_lens) -> list:
    """Each shard's crc32, computed on its rank's device (0 for an empty
    shard): on a card launched and not read, a 0-d tensor of
    ops.checksum.crc32_kernel (read_crc reads it); on the CPU the value."""
    return [(cs.crc32_kernel(d[HALO:HALO + n]) if d.is_cuda
             else cs.crc32(d[HALO:HALO + n])) if n else 0
            for d, n in zip(data_sh, shard_lens)]


def round_done(data_sh) -> list:
    """Per rank, an event recorded now on the stream its card works on
    (None for an empty shard or a CPU rank): a round's reads wait for it,
    not for the rounds launched after it."""
    out = []
    for d in data_sh:
        ev = None
        if d is not None and d.is_cuda:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(d.device))
        out.append(ev)
    return out


def read_crc(crc) -> int:
    """The value of one of checksums_sharded's crc32s."""
    if isinstance(crc, int):
        return crc
    return int(_device.to_host(crc)) & 0xFFFFFFFF


class ShardedDeflater:
    """Mesh-parallel compression, run from the host.

    mesh: a sequence of devices, one per rank (repeats allowed), or None
    for every CUDA device (parallel.mesh.make_mesh()). Over several
    processes: a ProcessMesh (parallel.mesh.make_mesh(group=...)), or this
    process's devices with the torch.distributed `group`; every process of
    the group then calls compress with the same bytes and gets the same
    result. The deflater holds the group as long as it lives: drop it
    before destroy_process_group() and the process's exit, in the order
    of parallel/mesh.py's teardown.
    """

    def __init__(self, mesh=None, level: int = 6, block_size: int = 1 << 16,
                 blocks_per_device: int = 8, mode: str = "members",
                 verify: bool = False, group=None):
        if mode not in ("members", "stream"):
            raise ValueError(mode)
        if mesh is None:
            mesh = make_mesh(group=group)
        if not isinstance(mesh, ProcessMesh):
            mesh = spanning(mesh, group)
        elif group is not None and group is not mesh.group:
            raise errors.IncorrectUseError(
                "the mesh spans another group than `group`")
        self.mesh = mesh.local
        self.group = mesh.group
        self.first = mesh.first
        self.ndev = mesh.size         # ranks over every process
        self.level = level
        self.bl = block_size
        self.bpd = blocks_per_device
        self.mode = mode
        # Elastic recovery (SURVEY §5): shards are independent, so a failed
        # shard's range can be re-encoded alone and spliced in. verify=True
        # decodes every shard against its source bytes after readback (the
        # failure detector); a failed shard is encoded again on its rank's
        # device.
        self.verify = verify
        # test seam: fault_hook(k, seg_bytes) -> seg_bytes (possibly
        # corrupted) lets tests kill the result of global rank k's shard
        self.fault_hook = None
        self.retries: list = []
        self._read_streams: dict = {}     # card -> the stream reads run on

    def _shard_ok(self, seg_bytes: bytes, src: np.ndarray, s: int,
                  ln: int) -> bool:
        """Failure detector: the shard's compressed bytes must decode back
        to its exact source range."""
        window = src[max(0, s - HALO):s].tobytes()
        try:
            if native.available():
                out, _, _ = native.inflate(seg_bytes, window,
                                           out_cap=max(ln, 1 << 12))
            else:
                out, _, _ = hi.inflate_raw(seg_bytes, window)
        except Exception:
            return False
        return out[:ln] == src[s:s + ln].tobytes()

    def _reencode_shard(self, src: np.ndarray, s: int, ln: int,
                        final: bool, device):
        """Retry path: encode one shard's range again on its own (members
        are independent; a stream shard sees its halo as a dictionary)."""
        enc = De.RawDeflater(level=self.level, block_size=self.bl,
                             batch=min(self.bpd, (ln + self.bl - 1)
                                       // self.bl) or 1, device=device)
        window = src[max(0, s - HALO):s].tobytes() \
            if self.mode == "stream" else b""
        return enc.compress(src[s:s + ln].tobytes(), dictionary=window,
                            final=final)

    @trace.request("ShardedDeflater.compress")
    @trace.span("shard")
    def compress(self, data: bytes):
        """Returns (blob, info). members mode: a multi-member gzip file, and
        in info each member's (offset, length, input bytes, index). stream
        mode: one gzip stream with the combined checksum.

        Over a group, every process encodes its own ranks' shards, and one
        gather gives every process every shard (the reference's ordered
        member gather, process_allgather). Input that differs between the
        processes, or an error in any process, raises in every process."""
        n = len(data)
        if self.group is not None:
            self._same_input(n, zlib.crc32(data))
        if n == 0:
            empty = H.emit_gzip_header() + b"\x03\x00" \
                + H.emit_gzip_trailer(0, 0)
            if self.mode == "members":
                return empty, {"mode": "members",
                               "members": [(0, len(empty), 0)], "n": 0}
            return empty, {"mode": "stream", "n": 0}
        # The error is reported and re-raised inside the except clause: a
        # local holding it would sit in its own traceback's frame, a cycle
        # that keeps this deflater, and so the group, past the caller's
        # teardown (ROADMAP C15).
        try:
            shards = self._encode_ranks(np.frombuffer(data, np.uint8))
        except Exception as e:
            if self.group is not None:
                self._gather([], e)
            raise
        if self.group is not None:
            shards = self._gather(shards, None)
        with trace.span("shard.assemble"):
            return self._assemble(sorted(shards, key=lambda r: r[0]), n)

    def _same_input(self, n: int, crc: int) -> None:
        """The first collective: every process must hold the same input."""
        seen = [None] * dist.get_world_size(self.group)
        dist.all_gather_object(seen, (n, crc), group=self.group)
        if any(x != seen[0] for x in seen):
            raise errors.IncorrectUseError(
                "the processes of the group compress different inputs "
                f"(length, crc32 by process: {seen})")

    @trace.span("shard.gather")
    def _gather(self, shards: list, err) -> list:
        """Every process's shard records, on every process; raises in every
        process when one failed (the others' errors travel as text)."""
        per = [None] * dist.get_world_size(self.group)
        dist.all_gather_object(
            per, (shards, None if err is None
                  else f"{type(err).__name__}: {err}"), group=self.group)
        failed = [(p, msg) for p, (_, msg) in enumerate(per) if msg]
        if failed and err is None:
            raise errors.JDeflateError(
                "the sharded encode failed in process "
                + "; in process ".join(f"{p}: {msg}" for p, msg in failed))
        return [r for recs, _ in per for r in recs]

    def _encode_ranks(self, arr: np.ndarray) -> list:
        """Encode this process's ranks' shards, round by round. Returns one
        record per shard: (source offset, compressed bytes, crc32, input
        bytes, index or None, retried)."""
        bl, bpd, d = self.bl, self.bpd, self.ndev
        shard_bytes = bl * bpd
        n = len(arr)
        chunk = levels.get_level(self.level).chunk
        nch = De._nch(bl, chunk)
        nw = De.words_bound(bl, bpd, chunk)
        ranks = range(self.first, self.first + len(self.mesh))

        shards = []
        launched = collections.deque()      # rounds launched, not read
        for pos in range(0, n, d * shard_bytes):
            trace.count("shard.rounds")
            launched.append(self._launch_round(arr, pos, shard_bytes, nw))
            if len(launched) > AHEAD:
                shards += self._read_round(arr, *launched.popleft(), nch)
        while launched:
            shards += self._read_round(arr, *launched.popleft(), nch)
        # a rank encodes a shard in some round iff it does in the first
        trace.count("shard.ranks", sum(k * shard_bytes < n for k in ranks))
        return shards

    def _launch_round(self, arr: np.ndarray, pos: int, shard_bytes: int,
                      nw: int) -> tuple:
        """Upload and launch this process's ranks' shards of the round at
        source offset pos: (starts, lengths, encode handles, crc32s)."""
        bl, n = self.bl, len(arr)
        starts = [pos + k * shard_bytes
                  for k in range(self.first, self.first + len(self.mesh))]
        lens = [max(0, min(n - s, shard_bytes)) for s in starts]
        dls = [0] * len(starts)
        fins = [-1] * len(starts)
        data_sh = [None] * len(starts)
        with trace.span("shard.upload"):
            for j, (s, ln) in enumerate(zip(starts, lens)):
                if not ln:
                    continue
                buf = np.zeros(HALO + shard_bytes + PAD, np.uint8)
                buf[HALO:HALO + ln] = arr[s:s + ln]
                if self.mode == "stream" and s > 0:
                    h = min(HALO, s)
                    buf[HALO - h:HALO] = arr[s - h:s]
                    dls[j] = h
                if self.mode == "members" or s + ln >= n:
                    fins[j] = (ln - 1) // bl
                data_sh[j] = _device.upload(buf, self.mesh[j])
        with trace.span("shard.launch"):
            handles = encode_sharded(data_sh, lens, dls, fins, bl, self.bpd,
                                     self.level, nw)
            crcs = checksums_sharded(data_sh, lens)
            done = round_done(data_sh)
        return starts, lens, handles, crcs, done

    def _read_round(self, arr: np.ndarray, starts: list, lens: list,
                    handles: list, crcs: list, done: list, nch: int) -> list:
        """Read a launched round back and make its shards' records. On a
        card the reads run on a side stream that waits for the round's
        event: on the card's own stream they would wait for the rounds
        launched after it too."""
        got = [None] * len(lens)
        with trace.span("shard.read"):
            for j, (h, ln, ev) in enumerate(zip(handles, lens, done)):
                if not ln:
                    continue
                if ev is None:
                    crcs[j] = read_crc(crcs[j])
                    got[j] = De.read_batch(h, self.bpd, nch)
                    continue
                stream = self._read_streams.get(self.mesh[j])
                if stream is None:
                    stream = self._read_streams[self.mesh[j]] = \
                        torch.cuda.Stream(device=self.mesh[j])
                with torch.cuda.stream(stream):
                    stream.wait_event(ev)
                    crcs[j] = read_crc(crcs[j])
                    got[j] = De.read_batch(h, self.bpd, nch)
        with trace.span("shard.assemble"):
            return [self._shard_record(arr, self.first + j, s, ln, crcs[j],
                                       got[j], self.mesh[j])
                    for j, (s, ln) in enumerate(zip(starts, lens)) if ln]

    def _shard_record(self, arr: np.ndarray, k: int, s: int, ln: int,
                      crc: int, got: tuple, device) -> tuple:
        """The record of global rank k's shard at source offset s from its
        read_batch result: its bytes (after the fault hook, and encoded
        again on `device` where verify finds them wrong), crc32 and
        index."""
        bl, bpd, n = self.bl, self.bpd, len(arr)
        total, body, st, sf, ho, gw, an = got
        final = s + ln >= n
        if self.mode == "members" or final:
            seg_bytes = body[: (total + 7) // 8].tobytes()
        else:
            # sync flush: 3 zero bits (BFINAL=0, BTYPE=00) + pad + 00 00
            # ff ff; no padding to 4 bytes
            seg_bytes = (body[: (total + 3 + 7) // 8].tobytes()
                         + b"\x00\x00\xff\xff")
        if self.fault_hook is not None:
            seg_bytes = self.fault_hook(k, seg_bytes)
        index, retried = None, False
        if self.verify or self.fault_hook is not None:
            probe = seg_bytes if (self.mode == "members" or final) \
                else seg_bytes + b"\x03\x00"
            if not self._shard_ok(probe, arr, s, ln):
                # the failed rank's crc32 is not trusted either: it is
                # taken again from the source bytes on the host
                seg_bytes, index = self._reencode_shard(
                    arr, s, ln, final=(self.mode == "members") or final,
                    device=device)
                crc, retried = zlib.crc32(arr[s:s + ln]), True
        if self.mode != "members":
            index = None
        elif index is None:
            # the default chunk, as the JAX sharded encoder passes
            # (ROADMAP C11)
            ib, iy, ia = De.index_entries_from_meta(
                bl, bpd, sf, ho, gw, an, st, (ln + bl - 1) // bl, ln, 0, 0)
            index = {"block_bits": ib, "block_bytes": iy, "win": ia,
                     "sync_points": [], "n": ln}
        return (s, seg_bytes, crc, ln, index, retried)

    def _assemble(self, shards: list, n: int):
        """(blob, info) from every shard's record, in shard order. The
        file is joined from its parts in one copy: it is host work after
        the cards' last round."""
        parts = []
        members = []
        pos = crc_total = 0
        trace.count("shard.retries", sum(r[5] for r in shards))
        for s, seg_bytes, crc, ln, index, retried in shards:
            if retried:
                self.retries.append((s, ln))
            if self.mode == "members":
                hdr = H.emit_gzip_header()
                parts += (hdr, seg_bytes, H.emit_gzip_trailer(crc, ln))
                mlen = len(hdr) + len(seg_bytes) + 8
                index["header_len"] = len(hdr)
                members.append((pos, mlen, ln, index))
                pos += mlen
            else:
                parts.append(seg_bytes)
                crc_total = cs.crc32_combine(crc_total, crc, ln)
        trace.count("shard.members", len(members))
        if self.mode == "members":
            return b"".join(parts), {"mode": "members", "members": members,
                                     "n": n}
        blob = b"".join([H.emit_gzip_header(), *parts,
                         H.emit_gzip_trailer(crc_total, n)])
        return blob, {"mode": "stream", "n": n}


def decompress_members(blob: bytes, info=None, device="cuda") -> bytes:
    """Decode a (possibly multi-member) gzip file (RFC 1952 §2.2) on
    `device`.

    With `info` from ShardedDeflater (each member's parallel-decode index),
    every member decodes through the windowed device path, each trailer
    checked. Without it, the one-shot multi-member decoder
    (stream.zstrm.decompress) takes the file.
    """
    if info and info.get("mode") == "members" and info.get("members"):
        dec = RawInflater(device=device)
        out = bytearray()
        for m in info["members"]:
            if len(m) >= 4 and isinstance(m[3], dict):
                mstart, mlen, _, index = m
                hl = index["header_len"]
                body = blob[mstart + hl: mstart + mlen - 8]
                o = dec.decompress(body, index=index)
                H.check_gzip_trailer(blob[mstart + mlen - 8: mstart + mlen],
                                     cs.crc32(o, device=dec.device), len(o))
                out += o
            else:
                mstart, mlen = m[0], m[1]
                out += zstrm.decompress(blob[mstart:mstart + mlen],
                                        format="gzip", device=device)
        return bytes(out)
    return zstrm.decompress(blob, format="gzip", device=device)
