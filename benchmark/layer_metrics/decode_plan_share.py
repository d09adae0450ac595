"""Share of the decode entry's time (zstrm.decompress) spent planning in
the host decode path, RawInflater._plan, in percent."""

SPANS = (
    ("jdeflate_tpu_torch.stream.zstrm", "decompress", "decode"),
    ("jdeflate_tpu_torch.codec.inflate", "RawInflater._plan", "decode.plan"),
)


def read(trace):
    total = trace.spans.get("decode")
    if not total:
        return None
    return 100.0 * trace.spans.get("decode.plan", 0.0) / total
