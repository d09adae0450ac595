"""The port's own request records (jdeflate_tpu_torch/trace.py) of the
traced stretch, for the per-layer readers that read the program's spans
and counters.

Each reader declares its SPANS with the one keep function below, on the
operations' own span names, so tracing.merge wraps each entry once and
keeps one record per call of the stretch in trace.kept[name]: the record
the call left, trace.last_request() just after it returned. Neither the
counting pass nor the fresh payload runs under the wrappers. A port
without trace.py keeps None, and the readers read nothing."""

ZSTRM = "jdeflate_tpu_torch.stream.zstrm"


def keep(args, result):
    try:
        from jdeflate_tpu_torch import trace
    except ImportError:
        return None
    return trace.last_request()


DECODE = ((ZSTRM, "decompress", "decode", keep),)
ENCODE = ((ZSTRM, "compress_with_index", "encode", keep),)


def records(trace, *names) -> list | None:
    """The kept records of the spans `names`, or None where a call kept
    none."""
    got = [r for name in names for r in trace.kept.get(name, [])]
    if not got or any(r is None for r in got):
        return None
    return got


def span_share(trace, span: str, over: str | None, *names):
    """100 x the summed seconds of `span` over the summed seconds of span
    `over` (None: of the whole records), over the records of `names`."""
    recs = records(trace, *names)
    if recs is None:
        return None
    total = sum(r["spans"].get(over, 0.0) if over else r["seconds"]
                for r in recs)
    if not total:
        return None
    return 100.0 * sum(r["spans"].get(span, 0.0) for r in recs) / total
