"""Per-blob readings of the benchmark's foreign zlib cell
(zlib6_foreign.decode): each payload's zlib stream and index made as the
cell's operation makes them (benchmark/operations/foreign_decode.py:
Python's zlib at the configuration's settings, RawInflater.build_index of
the body), then decoded through zstrm.decompress with that index, the
Adler-32 check included. Prints one JSON line per blob and a total:

    python3 scripts/foreign_blobs.py [--device cuda] [--calls 3]
        [--scale 1.0] [--out FILE]

from a checkout's root. Each line holds the blob's sizes, its index
entries and index seconds (the build_index request record), the median
seconds of the calls after the first (the first captures the decode's
programs), the windowed batches and stored items the decoder planned, the
bytes of the card's batches before the first that errs, of stored copies
and of the native decoder, and the first erring batch: its position among
the call's work items and among its windowed batches (ROADMAP C5), or
null. --scale shrinks every size (a CPU rehearsal).
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from benchmark import generator, spec  # noqa: E402

CELL = "zlib6_foreign.decode"


def blob(op, i: int, calls: int) -> dict:
    from jdeflate_tpu_torch import trace
    from jdeflate_tpu_torch.codec import inflate
    payload = op.payloads[i]
    stream, index = op.streams[i] = op.make(i)
    index_s = trace.last_request()["seconds"]
    secs = []
    for _ in range(calls):
        inflate.STATS_LOG.clear()
        t0 = time.perf_counter()
        out, _ = op.call(i)
        secs.append(time.perf_counter() - t0)
        if out != payload:
            raise RuntimeError(f"payload {i}: the decode differs")
    stats = list(inflate.STATS_LOG)
    rec = trace.last_request()["counters"]
    card, stored = inflate.card_bytes(stats)
    err = next((k for k, (_, _, e) in enumerate(stats) if e), None)
    err_win = (None if err is None else
               sum(kind == "win" for kind, _, _ in stats[:err]))
    return {"bytes": len(payload), "stream": len(stream),
            "entries": len(index["block_bits"]),
            "index_s": round(index_s, 4),
            "call_s": round(statistics.median(secs[1:] or secs), 4),
            "win_batches": rec["decode.win_batches"],
            "stored_items": rec["decode.stored_items"],
            "card": card, "stored": stored,
            "native": len(payload) - card - stored,
            "first_err_item": err, "first_err_win": err_win}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--calls", type=int, default=3)
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    from jdeflate_tpu_torch.stream import zstrm
    cell = spec.load_cell(CELL)
    sizes = {k: max(1, int(v * args.scale))
             for k, v in cell.config["payload"]["sizes"].items()}
    cfg = dict(cell.config, payload=dict(cell.config["payload"], sizes=sizes))
    kind, _ = generator.load(cell.traffic["op"])
    op = kind(cfg, cell.traffic, generator.make_payloads(cfg, cell.traffic),
              args.device, zstrm)
    op.streams = [None] * len(sizes)
    lines = []
    for i, name in enumerate(sizes):
        lines.append({"blob": name, **blob(op, i, args.calls)})
    n = sum(r["bytes"] for r in lines)
    total = {"blob": "all", "bytes": n,
             **{k: sum(r[k] for r in lines)
                for k in ("stream", "entries", "index_s", "call_s",
                          "win_batches", "stored_items", "card", "stored",
                          "native")},
             "card_share": 100.0 * sum(r["card"] for r in lines) / n,
             "stored_share": 100.0 * sum(r["stored"] for r in lines) / n,
             "native_share": 100.0 * sum(r["native"] for r in lines) / n}
    text = "\n".join(json.dumps(r) for r in lines + [total])
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")


if __name__ == "__main__":
    main()
