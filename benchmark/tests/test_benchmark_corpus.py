"""The payload generator: deterministic per seed, the configured sizes."""
import hashlib
import json
import os

import pytest

from benchmark import corpus, generator, spec

SILESIA = {"dickens": 10192446, "mozilla": 51220480, "mr": 9970564,
           "nci": 33553445, "ooffice": 6152192, "osdb": 10085684,
           "reymont": 6627202, "samba": 21606400, "sao": 7251944,
           "webster": 41458703, "x-ray": 8474240, "xml": 5345280}


def test_real_text_is_frozen():
    blob = corpus.real_text()
    assert len(blob) == 315242
    assert hashlib.sha256(blob).hexdigest() == (
        "3ad90b6591bdb609d6a93ed5a1b5be970f8685e36f1dc330164fe1ac2492c263")


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 12345, 2**33 + 1, -5])
def test_same_seed_same_bytes(seed):
    a = corpus.make_payload(300_000, seed, 3)
    assert a == corpus.make_payload(300_000, seed, 3)
    assert len(a) == 300_000
    assert a != corpus.make_payload(300_000, seed + 1, 3)
    assert a != corpus.make_payload(300_000, seed, 4)


def test_text_payloads_hold_text_only():
    p = corpus.make_payload(1 << 20, 11, 0, corpus.TEXT)
    assert len(p) == 1 << 20
    text = set(corpus.real_text()) | set(b"".join(corpus.WORDS))
    assert set(p) <= text         # words and sources only
    mix = corpus.make_payload(1 << 20, 11, 0, corpus.MIX)
    assert not set(mix) <= text


def test_silesia_sizes():
    cfg = spec.load_json(os.path.join(spec.HERE, "configs",
                                      "deflate6_silesia.json"))
    assert cfg["payload"]["sizes"] == SILESIA
    sizes = generator.payload_sizes(cfg, {})
    assert sum(sizes) == 211938580
    assert sizes == list(SILESIA.values())


def test_pool_sizes():
    cfg = spec.load_json(os.path.join(spec.HERE, "configs",
                                      "gzip1_1mib.json"))
    sizes = generator.payload_sizes(cfg, {"pool": 64})
    assert sizes == [1 << 20] * 64


def test_order_is_a_seeded_permutation():
    a = generator.call_order(12, 2**31 + 7)
    assert sorted(a) == list(range(12))
    assert a == generator.call_order(12, 2**31 + 7)
    assert any(generator.call_order(12, s) != a for s in range(5))


def test_payloads_of_a_config():
    cfg = {"payload": {"content": "silesia_mix", "content_seed": 3,
                       "sizes": {"a": 70_000, "b": 1_000}}}
    ps = generator.make_payloads(cfg, {})
    assert [len(p) for p in ps] == [70_000, 1_000]
    assert ps == generator.make_payloads(json.loads(json.dumps(cfg)), {})
    assert ps[0] == corpus.make_payload(70_000, 3, 0)
    cfg["payload"]["content_seed"] = 4
    assert generator.make_payloads(cfg, {})[0] != ps[0]


def test_fresh_payload_is_drawn_from_the_run_seed():
    cfg = {"payload": {"content": "text", "content_seed": 3,
                       "sizes": {"a": 70_000, "b": 1_000, "c": 5_000}}}
    seed = 2**33 + 5
    a = generator.fresh_payload(cfg, {}, seed)
    assert a == generator.fresh_payload(json.loads(json.dumps(cfg)), {}, seed)
    assert len(a) in (70_000, 1_000, 5_000)
    assert a not in generator.make_payloads(cfg, {})
    got = {generator.fresh_payload(cfg, {}, s) for s in range(12)}
    assert len(got) == 12 and len({len(p) for p in got}) == 3
