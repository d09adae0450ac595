"""Multi-process data parallel: the port's ShardedDeflater over a
torch.distributed gloo group, the counterpart of the JAX package's
jax.distributed sharded encode (scripts/multiproc_smoke.py).

Each layout (processes x local ranks: 2x1, 3x1, 2x2) is one spawn of
worker processes (this file run as a script), on the CPU with device="cpu"
and torch on one thread, which runs every case in sequence and writes its
results under the module's temporary directory. Every process's blob, info
and retries must equal those of one-process ShardedDeflater on the same
global rank count (make_mesh(W*L, device="cpu")), computed here, and on
2x2 also the JAX ShardedDeflater's on four devices of the 8-device CPU mesh
(tests/conftest.py). Input that differs between the processes, and an
error in one process, must raise in every process. Tolerance: exact
equality. Every join has a timeout and stops the workers on expiry
(SIGTERM first: each worker then dumps its threads' stacks into its log);
a late or failed spawn reports every worker's return code, seconds since
spawn and log tail. Every worker tears down in the order of
parallel/mesh.py and reports the gloo threads left after it, which must
be none (ROADMAP C15).

Run as `PYTHONPATH=. python tests/test_torch_multiproc.py --stress
[explode|full] [SPAWNS [AT_ONCE]]` from the repository's root, the file
spawns the 2x2 layout SPAWNS times (default 120), AT_ONCE at a time
(default 10), and prints each failed spawn's report and a JSON summary.

Worker processes do not run tests/conftest.py, so each is handed the
parent's capped probe depths (ROADMAP C4) before it encodes.
"""
import time

_T0 = time.monotonic()   # a worker's log times count from here, imports in

import datetime
import faulthandler
import gc
import os
import pickle
import signal
import subprocess
import sys

import pytest
import torch
import torch.distributed as dist

from chip_smoke import canonical, gloo_threads
from jdeflate_tpu_torch.codec import levels as tlevels
from jdeflate_tpu_torch.parallel import mesh as tmesh
from jdeflate_tpu_torch.parallel import shard as tshard

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the sizes of test_torch_parallel.py; level 9 takes 4 KiB blocks, whose
# 2 KiB splitter chunks show the member index of ROADMAP C11
BL, BPD, LEVEL = 2048, 2, 6
L9 = dict(level=9, block_size=4096, blocks_per_device=2)
JOIN_S = 240          # one spawn, every case included
# The group's rendezvous and collectives wait as long as the join: a worker
# that is only late (a starved import of torch, a slow first build of the
# native library) then delays its peers instead of timing them out, which
# broke the group and turned one late process into a failed layout.
PG_TIMEOUT_S = JOIN_S


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small; torch's default thread pool only spins
    against the other test workers' JAX compiles."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _capped_probes():
    """Both packages run the same (CPU-capped) probe depths,
    tests/conftest.py; imported here, not at the top, so that the workers,
    which run this file as a script, import no JAX."""
    from jdeflate_tpu.codec import levels as jlevels
    tlevels._PROBE_CAP.update(jlevels._PROBE_CAP)


def _zero_12(seg):
    return seg[:4] + bytes(8) + seg[12:]


def _truncate(seg):
    return seg[:-6] + bytes(6)


def _explode(seg):
    raise RuntimeError("rank fault")


HOOKS = {"zero_12": _zero_12, "truncate": _truncate, "explode": _explode}


def _killer(rank, how):
    """A fault hook that hands global rank `rank`'s first shard to
    HOOKS[how]."""
    killed = []

    def hook(k, seg):
        if k == rank and not killed:
            killed.append(k)
            return HOOKS[how](seg)
        return seg
    return hook


@pytest.fixture(scope="module")
def cases(corpus):
    return make_cases(corpus)


def make_cases(corpus) -> dict:
    """name -> (data, ShardedDeflater keywords, fault hook or None). The
    first rank of process 1 is global rank `local`, so a hook given
    "p1" hits process 1 in every layout."""
    r4 = 4 * BPD * BL
    base = dict(level=LEVEL, block_size=BL, blocks_per_device=BPD)
    return {
        # 3-5 rounds, a ragged tail shard
        "members": (corpus("text", 2 * r4 + 777), {**base, "mode": "members"},
                    None),
        "stream": (corpus("binary", 2 * r4 + 123), {**base, "mode": "stream"},
                   None),
        "empty_members": (b"", {**base, "mode": "members"}, None),
        "empty_stream": (b"", {**base, "mode": "stream"}, None),
        "level9": (b"".join(corpus(k, 2048) for k in ("text", "random") * 8),
                   {**L9, "mode": "members"}, None),
        "fault_members": (corpus("text", 2 * r4 + 50),
                          {**base, "mode": "members", "verify": True},
                          ("p1", "zero_12")),
        "fault_stream": (corpus("binary", 2 * r4 + 50),
                         {**base, "mode": "stream", "verify": True},
                         ("p1", "truncate")),
    }


def _note(what):
    print(f"[{time.monotonic() - _T0:.1f} s] {what}", flush=True)


def _worker(job_path: str, rank: int) -> None:
    """One process of a spawn: join the gloo group, run every case of the
    job in sequence, tear down in the order of parallel/mesh.py (the group
    ends with its last reference, before the interpreter finalizes), write
    {case: result, "threads": gloo threads left after the teardown} to
    out<rank>.pkl. With job["gc"] False the cyclic garbage collector is
    off, so that only reference counts can end the group."""
    # a join that times out sends SIGTERM first: the log then shows where
    # every thread of this process was
    faulthandler.register(signal.SIGTERM, all_threads=True)
    with open(job_path, "rb") as f:
        job = pickle.load(f)
    if not job["gc"]:
        gc.disable()
    torch.set_num_threads(1)
    _note("job read")
    tlevels._PROBE_CAP.update(job["probe_cap"])
    dist.init_process_group(
        "gloo", init_method="file://" + job["init"],
        world_size=job["world"], rank=rank,
        timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
    _note("group joined")
    try:
        # every mesh, deflater and group reference is local to _run_cases
        res = _run_cases(job, rank)
    finally:
        dist.destroy_process_group()
    res["threads"] = gloo_threads()
    with open(os.path.join(os.path.dirname(job_path), f"out{rank}.pkl"),
              "wb") as f:
        pickle.dump(res, f)
    _note(f"done; gloo threads left: {res['threads']}")


def _run_cases(job: dict, rank: int) -> dict:
    """Run every case of the job on the default group: {case: ("ok",
    blob, info, retries) or ("raised", error class, message)}."""
    group = dist.group.WORLD
    local = job["local"]
    res = {}
    if job["device"] == "cpu":
        mesh = tmesh.make_mesh(local, device="cpu", group=group)
    else:
        mesh = tmesh.make_mesh(group=group)
    res["mesh"] = (tuple(str(d) for d in mesh.local), mesh.first, mesh.size)
    for name, (data, kw, hook) in job["cases"].items():
        _note(f"case {name}")
        if name == "mismatch":
            data = data + bytes([rank])
        enc = tshard.ShardedDeflater(mesh=mesh, **kw)
        if hook is not None:
            enc.fault_hook = _killer(local if hook[0] == "p1" else hook[0],
                                     hook[1])
        try:
            blob, info = enc.compress(data)
            res[name] = ("ok", blob, info, enc.retries)
        except Exception as e:
            res[name] = ("raised", type(e).__name__, str(e))
    if job["device"] == "cpu":
        res["rules"] = _group_mesh_rules(group)
    return res


def _group_mesh_rules(group) -> dict:
    """What make_mesh and ShardedDeflater do with a group in a process
    without a card: name -> the error's class name, or None."""
    out = {}
    for name, call in (
            ("cpu_without_n", lambda: tmesh.make_mesh(device="cpu",
                                                      group=group)),
            ("cuda_without_card", lambda: tmesh.make_mesh(group=group)),
            ("deflater_without_card",
             lambda: tshard.ShardedDeflater(group=group))):
        try:
            call()
            out[name] = None
        except Exception as e:
            out[name] = type(e).__name__
    return out


def _spawn(tmp, world: int, local: int, job_cases: dict, device="cpu",
           gc_on: bool = True):
    """Start `world` workers on a job in directory tmp (gc_on False: the
    workers' cyclic garbage collector off)."""
    tmp.mkdir(parents=True, exist_ok=True)
    job = {"probe_cap": dict(tlevels._PROBE_CAP), "world": world,
           "local": local, "device": device, "init": str(tmp / "pg"),
           "cases": job_cases, "gc": gc_on}
    with open(tmp / "job.pkl", "wb") as f:
        pickle.dump(job, f)
    return _start([[sys.executable, os.path.abspath(__file__),
                    str(tmp / "job.pkl"), str(r)] for r in range(world)],
                  tmp)


def _start(cmds, tmp) -> list:
    """One process per command, each logging to tmp/log<r>.txt."""
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        filter(None, [REPO, os.environ.get("PYTHONPATH")]))}
    procs = []
    for r, cmd in enumerate(cmds):
        log = open(tmp / f"log{r}.txt", "wb")
        procs.append(subprocess.Popen(cmd, stdout=log,
                                      stderr=subprocess.STDOUT, cwd=REPO,
                                      env=env))
        procs[-1].spawned = time.monotonic()
        log.close()
    return procs


def _report(procs, tmp, what: str) -> str:
    """What each worker did: its return code, its seconds since spawn and
    the tail of its log."""
    lines = [what]
    for r, p in enumerate(procs):
        log = (tmp / f"log{r}.txt").read_text(errors="replace")
        lines.append(f"--- worker {r}: return code {p.returncode}, "
                     f"{time.monotonic() - p.spawned:.1f} s since spawn; "
                     f"log tail:\n{log[-3000:]}")
    return "\n".join(lines)


def _join(procs, tmp, timeout: float = JOIN_S) -> list:
    """Wait for every worker (stopping all of them once `timeout` seconds
    have passed) and return each one's results; fail on a timeout or a
    worker that failed, with every worker's return code, age and log."""
    deadline = time.monotonic() + timeout
    late = False
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        late = True
    finally:
        for p in procs:
            if p.poll() is None:
                # SIGTERM dumps the worker's stacks into its log first
                p.terminate()
                try:
                    p.wait(timeout=5)
                except subprocess.TimeoutExpired:
                    pass
                p.kill()
                p.wait()
    if late:
        pytest.fail(_report(procs, tmp,
                            f"workers did not finish in {timeout} s"))
    if any(p.returncode != 0 for p in procs):
        pytest.fail(_report(procs, tmp, "a worker failed"))
    outs = []
    for r in range(len(procs)):
        with open(tmp / f"out{r}.pkl", "rb") as f:
            outs.append(pickle.load(f))
    return outs


def _one_process(cases, nranks):
    """One-process ShardedDeflater on nranks CPU ranks, every case."""
    mesh = tmesh.make_mesh(nranks, device="cpu")
    want = {}
    for name, (data, kw, hook) in cases.items():
        enc = tshard.ShardedDeflater(mesh=mesh, **kw)
        if hook is not None:
            enc.fault_hook = _killer(hook[0], hook[1])
        blob, info = enc.compress(data)
        want[name] = ("ok", blob, info, enc.retries)
    return want


LAYOUTS = [(2, 1), (3, 1), (2, 2)]
NAMES = ["members", "stream", "empty_members", "empty_stream", "level9",
         "fault_members", "fault_stream"]


def _layout_job(cases) -> dict:
    """A layout's job: every case with its hook on process 1, then the
    cases that must raise (input that differs by process, a hook that
    raises in process 1) and a case after them."""
    job_cases = {name: (data, kw, hook if hook is None
                        else ("p1", hook[1]))
                 for name, (data, kw, hook) in cases.items()}
    data, base, _ = cases["members"]
    job_cases["mismatch"] = (data, base, None)
    job_cases.update(_explode_job(cases))
    job_cases["after_errors"] = cases["members"]
    return job_cases


def _explode_job(cases) -> dict:
    """The members case with a hook that raises in process 1."""
    data, base, _ = cases["members"]
    return {"explode": (data, base, ("p1", "explode"))}


def _run_layout(world, local, cases, tmp):
    """One spawn of `world` processes x `local` ranks running every case,
    plus the cases that must raise; the one-process results are computed
    here while the workers run. Returns (the workers' results, one-process
    results)."""
    procs = _spawn(tmp, world, local, _layout_job(cases))
    try:
        want = _one_process({name: (data, kw, hook if hook is None
                                    else (local, hook[1]))
                             for name, (data, kw, hook) in cases.items()},
                            world * local)
    finally:
        outs = _join(procs, tmp)
    return outs, want


@pytest.fixture(scope="module")
def spawns(cases, tmp_path_factory):
    """layout -> _run_layout's result, each layout spawned once. A failed
    spawn is not repeated: the first case of its layout fails with its
    report, and every later case with the same report."""
    done, failed = {}, {}

    def get(world, local):
        key = world, local
        if key in failed:
            pytest.fail(f"the {world}x{local} spawn failed for an earlier "
                        f"case of this layout:\n{failed[key]}",
                        pytrace=False)
        if key not in done:
            try:
                done[key] = _run_layout(
                    world, local, cases,
                    tmp_path_factory.mktemp(f"mp{world}x{local}"))
            except (Exception, pytest.fail.Exception) as e:
                failed[key] = f"{type(e).__name__}: {e}"
                raise
        return done[key]
    return get


@pytest.fixture(scope="module", params=LAYOUTS,
                ids=lambda x: f"{x[0]}x{x[1]}")
def spawned(request, spawns):
    """(layout, the workers' results, one-process results)."""
    return (request.param, *spawns(*request.param))


def test_join_reports_every_worker(tmp_path):
    """A join that times out names each worker's return code, age and log,
    with the stacks a late worker dumps on SIGTERM; a join whose worker
    failed names its return code and log."""
    late = ("import faulthandler, signal, time; faulthandler.register("
            "signal.SIGTERM, all_threads=True); print('worker up', "
            "flush=True); time.sleep(300)")
    procs = _start([[sys.executable, "-c", late],
                    [sys.executable, "-c", "print('quick worker')"]],
                   tmp_path)
    deadline = time.monotonic() + 120
    while "worker up" not in (tmp_path / "log0.txt").read_text() \
            and time.monotonic() < deadline:
        time.sleep(0.1)
    procs[1].wait(timeout=120)
    with pytest.raises(pytest.fail.Exception) as e:
        _join(procs, tmp_path, timeout=0.5)
    msg = str(e.value)
    assert "did not finish in 0.5 s" in msg
    assert "worker 0: return code" in msg and "since spawn" in msg
    assert "worker up" in msg
    assert 'File "<string>"' in msg            # the late worker's stack
    assert "worker 1: return code 0" in msg and "quick worker" in msg
    assert all(p.poll() is not None for p in procs)

    procs = _start([[sys.executable, "-c",
                     "import sys; print('failing worker'); sys.exit(3)"]],
                   tmp_path)
    with pytest.raises(pytest.fail.Exception) as e:
        _join(procs, tmp_path, timeout=120)
    assert "a worker failed" in str(e.value)
    assert "worker 0: return code 3" in str(e.value)
    assert "failing worker" in str(e.value)


@pytest.mark.parametrize("name", NAMES)
def test_group_matches_one_process(spawned, name):
    """Every process of the group gives the blob, info and retries of one
    process on the same global rank count: both modes, empty input,
    level 9, verify with the fault hook on a rank of process 1."""
    _, outs, want = spawned
    for r, out in enumerate(outs):
        assert out[name][0] == "ok", (r, out[name])
        assert canonical(out[name]) == canonical(want[name]), r
    if name.startswith("fault"):
        assert want[name][3], "the fault hook caused no retry"


def test_group_mesh(spawned):
    """The global mesh is every process's ranks in process-rank order; a
    CPU mesh needs n, and a CUDA one a card, with a group as without."""
    (world, local), outs, _ = spawned
    for r, out in enumerate(outs):
        assert out["mesh"] == (("cpu",) * local, r * local, world * local)
        if not torch.cuda.is_available():
            assert out["rules"] == dict.fromkeys(
                ("cpu_without_n", "cuda_without_card",
                 "deflater_without_card"), "IncorrectUseError")


def test_group_errors_raise_everywhere(spawned):
    """Different input in each process raises IncorrectUseError in every
    process; an error in process 1 raises there and in every other
    process; the group then still works."""
    _, outs, want = spawned
    for r, out in enumerate(outs):
        assert out["mismatch"][:2] == ("raised", "IncorrectUseError"), r
        if r == 1:
            assert out["explode"][1:] == ("RuntimeError", "rank fault")
        else:
            assert out["explode"][:2] == ("raised", "JDeflateError"), r
            assert "process 1: RuntimeError: rank fault" in out["explode"][2]
        assert canonical(out["after_errors"]) == canonical(want["members"]), r


def test_teardown_ends_gloo_threads(spawned):
    """After the worker's teardown no gloo thread is left in any process,
    so none is alive while the interpreter finalizes (ROADMAP C15)."""
    _, outs, _ = spawned
    for r, out in enumerate(outs):
        assert out["threads"] == [], r


def test_raise_releases_group(cases, tmp_path):
    """ROADMAP C15: the process whose fault hook raised in compress must
    let its group go with the caller's last reference. With the cyclic
    garbage collector off in the workers (reference counts alone), 2
    processes x 2 ranks run the explode case and tear down; no gloo
    thread may be left in either process, and the error contract holds.
    A group kept alive past the teardown (by a cycle through the raised
    error's traceback) keeps its run-loop threads into interpreter
    finalization, where one that releases a finished work's tensor waits
    for the GIL, is ended by pthread_exit and aborts the process."""
    outs = _join(_spawn(tmp_path, 2, 2, _explode_job(cases), gc_on=False),
                 tmp_path)
    assert outs[1]["explode"] == ("raised", "RuntimeError", "rank fault")
    assert outs[0]["explode"][:2] == ("raised", "JDeflateError")
    assert "process 1: RuntimeError: rank fault" in outs[0]["explode"][2]
    for r, out in enumerate(outs):
        assert out["threads"] == [], r


def test_raise_leaves_no_cycle(cases):
    """A compress that raises leaves no reference cycle behind: with the
    cyclic garbage collector off, the deflater (which holds the group of
    a process mesh) goes with its last reference once the error is
    handled."""
    import weakref
    data, kw, _ = cases["members"]
    was = gc.isenabled()
    gc.disable()
    try:
        enc = tshard.ShardedDeflater(mesh=tmesh.make_mesh(2, device="cpu"),
                                     **kw)
        enc.fault_hook = _killer(0, "explode")
        alive = weakref.ref(enc)
        with pytest.raises(RuntimeError, match="rank fault"):
            enc.compress(data)
        del enc
        assert alive() is None
    finally:
        if was:
            gc.enable()


@pytest.fixture(scope="module")
def jax_4ranks(cases):
    """The JAX ShardedDeflater on four devices of the 8-device CPU mesh,
    every case, with the hook on global rank 2 (process 1 of 2x2)."""
    from jdeflate_tpu.codec import levels as jlevels
    from jdeflate_tpu.parallel import mesh as jmesh
    from jdeflate_tpu.parallel import shard as jshard
    assert tlevels._PROBE_CAP == jlevels._PROBE_CAP
    mesh = jmesh.make_mesh(4)
    want = {}
    for name, (data, kw, hook) in cases.items():
        enc = jshard.ShardedDeflater(mesh=mesh, **kw)
        if hook is not None:
            enc.fault_hook = _killer(2, hook[1])
        blob, info = enc.compress(data)
        want[name] = ("ok", blob, info, enc.retries)
    return want


@pytest.mark.parametrize("name", NAMES)
def test_2x2_matches_jax(spawns, jax_4ranks, name):
    """2 processes x 2 local ranks give the JAX package's blob, info and
    retries on four ranks."""
    outs, _ = spawns(2, 2)
    for r, out in enumerate(outs):
        assert canonical(out[name]) == canonical(jax_4ranks[name]), r


@pytest.mark.cuda
def test_two_processes_on_one_card(cases, tmp_path):
    """Two gloo processes with one rank each on cuda:0 give the members
    blob and info of one process on ["cuda:0"] * 2."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    data, kw, _ = cases["members"]
    procs = _spawn(tmp_path, 2, 1, {"members": (data, kw, None)},
                   device="cuda")
    try:
        enc = tshard.ShardedDeflater(mesh=["cuda:0"] * 2, **kw)
        want = ("ok", *enc.compress(data), [])
    finally:
        outs = _join(procs, tmp_path, timeout=300)
    for r, out in enumerate(outs):
        assert out["mesh"] == (("cuda:0",), r, 2)
        assert canonical(out["members"]) == canonical(want), r


def stress(job: str, spawns: int, at_once: int) -> int:
    """The concurrent 2x2 stress: `spawns` spawns of 2 processes x 2 local
    ranks, `at_once` of them running at a time, on the job "explode" (that
    case alone) or "full" (a layout's whole job). Prints each failed
    spawn's report and a JSON summary line; returns the failed count."""
    import collections
    import json
    import pathlib
    import tempfile
    import conftest                 # the tests' corpus and probe caps
    tlevels._PROBE_CAP.update(conftest._levels._PROBE_CAP)
    rng = conftest.np.random.default_rng(1234)
    cases = make_cases(lambda kind, n: conftest.make_corpus(rng, kind, n))
    job_cases = _layout_job(cases) if job == "full" else _explode_job(cases)
    rcs, failed, running, started = collections.Counter(), 0, [], 0
    t0 = time.monotonic()
    with tempfile.TemporaryDirectory() as root:
        while started < spawns or running:
            while started < spawns and len(running) < at_once:
                tmp = pathlib.Path(root, f"s{started}")
                running.append((tmp, _spawn(tmp, 2, 2, job_cases),
                                time.monotonic() + JOIN_S))
                started += 1
            time.sleep(0.1)
            for item in list(running):
                tmp, procs, deadline = item
                late = time.monotonic() > deadline
                if not late and any(p.poll() is None for p in procs):
                    continue
                running.remove(item)
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
                    rcs[p.returncode] += 1
                if late or any(p.returncode for p in procs):
                    failed += 1
                    print(_report(procs, tmp, f"spawn {tmp.name} failed"
                                  + (" (late)" if late else "")), flush=True)
    print(json.dumps({"job": job, "layout": "2x2", "spawns": spawns,
                      "at_once": at_once, "failed": failed,
                      "return_codes": {str(k): v for k, v in rcs.items()},
                      "seconds": time.monotonic() - t0}), flush=True)
    return failed


if __name__ == "__main__":
    if sys.argv[1] == "--stress":
        # python tests/test_torch_multiproc.py --stress [explode|full]
        #     [SPAWNS [AT_ONCE]]
        args = sys.argv[2:] + ["explode", "120", "10"][len(sys.argv) - 2:]
        sys.exit(1 if stress(args[0], int(args[1]), int(args[2])) else 0)
    _worker(sys.argv[1], int(sys.argv[2]))
