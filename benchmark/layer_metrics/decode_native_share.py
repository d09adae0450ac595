"""Share of the decoded bytes that the native decoder produced, in percent:
each RawInflater.decompress's last_stats hold (kind, produced, err) per
batch; the card's batches up to the first that errs and the stored copies
are not the native decoder's (the rule of codec/inflate.py::card_bytes),
the rest of the call's output is."""


def _last_stats(args, result):
    return list(args[0].last_stats)


SPANS = (("jdeflate_tpu_torch.codec.inflate", "RawInflater.decompress",
          "decode.inflater", _last_stats),)


def read(trace):
    stats_of_calls = trace.kept.get("decode.inflater")
    if not trace.decoded or not stats_of_calls:
        return None
    other = 0
    for stats in stats_of_calls:
        for kind, produced, err in stats:
            if err:
                break
            other += produced
    return 100.0 * (trace.decoded - other) / trace.decoded
