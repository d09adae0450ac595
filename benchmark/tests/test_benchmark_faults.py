"""A run's `correct` against faults planted under the timed path.

On the CPU: each cell, cut to a tiny size, driven through harness.run_cell
without the look for a card: sound, it is correct; with each fault of
faults.py (the control, a byte altered where it is produced, half of the
work left out, a stale answer) it is not. On a card (marker cuda): the
control through benchmark/run.py at the cell's own size."""
import json
import os
import subprocess
import sys
import time

import pytest
import torch

from benchmark import faults, generator, harness, spec

SIZES = {"deflate6_silesia.decode": {"a": 40_000, "b": 90_000},
         "deflate6_silesia.encode": {"a": 40_000, "b": 70_000}}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny(name: str) -> spec.Cell:
    c = spec.load_cell(name)
    c.config = dict(c.config, block_size=16384, batch=4)
    pay = dict(c.config["payload"])
    if name in SIZES:
        pay["sizes"] = SIZES[name]
        c.traffic = dict(c.traffic, trace={"calls": 3})
    else:
        pay["size"] = 32768
        c.traffic = dict(c.traffic, pool=2, trace={"calls": 3},
                         check={"sample": 3})
    c.config["payload"] = pay
    return c


def run(name, fault=None, trace=True, seed=2**31 + 99):
    return harness.run_cell(tiny(name), seed, 0.0, trace, time.perf_counter(),
                            device="cpu", fault=fault)


@pytest.mark.parametrize("name", list(SIZES) + ["gzip1_1mib.roundtrip"])
def test_sound_run_is_correct(name):
    r = run(name)
    assert r["correct"], r["checks"]
    assert r["attempted"] == 3 and r["failed"] == 0
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("name", list(SIZES) + ["gzip1_1mib.roundtrip"])
def test_measured_run_reports_its_metrics(name):
    r = run(name, trace=False)
    assert r["correct"], r["checks"]
    want = {m["name"] for m in spec.load_cell(name).end_to_end}
    assert set(r["metrics"]) == want
    assert all(m["value"] > 0 for m in r["metrics"].values())


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("name", list(SIZES) + ["gzip1_1mib.roundtrip"])
def test_fault_is_not_correct(name, fault):
    r = run(name, fault)
    assert not r["correct"], (fault, r["checks"])


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SIZES) + ["gzip1_1mib.roundtrip"])
def test_control_on_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cmd = [sys.executable, os.path.join(spec.HERE, "run.py"), "--workload",
           name, "--seed", "2147483711", "--seconds", "3", "--trace", "0"]
    for fault, want in ((None, True), ("control", False)):
        extra = ["--fault", fault] if fault else []
        r = subprocess.run(cmd + extra, capture_output=True, text=True,
                           cwd=spec.ROOT, timeout=900)
        assert r.returncode == 0, r.stderr[-2000:]
        assert json.loads(r.stdout.splitlines()[-1])["correct"] is want



class FreshOnly:
    """The port's zstrm with every answer on a payload outside the cell's
    pool altered: only the fresh payload of the run's seed meets it."""

    def __init__(self, cell):
        from jdeflate_tpu_torch.stream import zstrm
        self.zstrm = zstrm
        self.pool = generator.make_payloads(cell.config, cell.traffic)

    def compress_with_index(self, data, **k):
        stream, index, hl = self.zstrm.compress_with_index(data, **k)
        if data not in self.pool:
            stream = stream[:hl] + faults.flip(stream[hl:-8]) + stream[-8:]
        return stream, index, hl

    def decompress(self, *a, **k):
        out = self.zstrm.decompress(*a, **k)
        return out if out in self.pool else faults.flip(out)


@pytest.mark.parametrize("name", list(SIZES) + ["gzip1_1mib.roundtrip"])
def test_fault_on_the_fresh_payload_is_not_correct(name):
    c = tiny(name)
    r = harness.run_cell(c, 2**31 + 99, 0.0, True, time.perf_counter(),
                         device="cpu", zstrm=FreshOnly(c))
    assert r["failed"] == 0 and not r["correct"], r["checks"]
