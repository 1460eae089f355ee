"""The port's sharded solve over several processes (torch.distributed,
gloo on the CPU) against one process driving the same mesh positions,
and against the JAX package.

Two worker processes (tests/torch_processes_worker.py) of two CPU mesh
positions each, started by torchrun (`torch.distributed.run --standalone`:
they bring up torch.distributed from its environment, as the command
line's entry does), form a mesh of four; a third process drives the same
four positions alone (`solo`). All three run the same things: the
writers on a forest, main.run on the canonical parameters (3 levels,
16^3 base, (2, 2) pencils), the periodic box at 32^3 on x-slabs and on
pencils, a periodic box whose cut depths the second process holds no
shard of, the JAX package's test forest with its sibling pair batched and
spread over the processes (one patch on each), and the command line's
entry, main.main, whose mesh over the
two processes main.choose_mesh builds (one position a process; the one
process names the same two). Every result of the two processes is held
to the one process's bit for bit (histories, Krylov counts, K, the
result's levels, the files), their counters to add up to its, and the
canonical histories to the JAX package's single-process one within the
limits of the JAX package's own two-process test
(tests/test_multihost.py). The unit tests below need no second process.
"""

import datetime
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from mg_ic_code_tpu_torch.ops import cuda_ext, kernel_counts
from mg_ic_code_tpu_torch.parallel import distributed as tdist
from mg_ic_code_tpu_torch.parallel import mesh as tmesh
from mg_ic_code_tpu_torch.parallel import transport

h5py = pytest.importorskip("h5py")

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_processes_worker.py")
RUNS = ("io", "canonical", "periodic_x", "periodic_pencil", "periodic_ycut",
        "entry")
OWNERS = [0, 0, 1, 1]
# the entry's mesh: main.choose_mesh's, one CPU position a process
ENTRY_OWNERS = [0, 1]
# kernels that run on the shards of a cut level: each process launches
# its own shards' calls. Every other kernel runs on the levels and depths
# the mesh does not cut, which every process holds and computes whole.
SHARD_KERNELS = ("multisweep_relax_halo", "multisweep_relax_tiled_pre")
# the test's limit on the workers (their own watchdog ends them first:
# torch_processes_worker.WATCHDOG_S)
WAIT_S = 85


def _result(run_dir, rank: int, out: str) -> dict:
    """What process `rank` of a run wrote to its result.json."""
    path = run_dir / f"p{rank}" / "result.json"
    assert path.exists(), f"no {path}:\n{out[-4000:]}"
    return json.loads(path.read_text())


def _jax_canonical_history():
    """The JAX package's single-process history of the canonical run (x64,
    as its own tests run it)."""
    from mg_ic_code_tpu.config import load_params as jload
    from mg_ic_code_tpu.solver import nonlinear as jnl

    from tests.torch_processes_worker import CANONICAL, PARAMS

    cfg = jload(os.path.join(PARAMS, "canonical.txt"),
                overrides=[o for o in CANONICAL if "verbosity" not in o]
                + ["verbosity = 0"])
    res = jnl.poisson_solve(cfg, verbose=False)
    return res.dpsi_norm_history, res.linear_iters


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both processes of the pair and the one-process reference, started
    together; the JAX package's history meanwhile."""
    base = tmp_path_factory.mktemp("processes")
    env = dict(os.environ, OMP_NUM_THREADS="1")

    def start(*argv):
        return subprocess.Popen(
            [sys.executable, *argv], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, env=env, text=True)

    procs = {"pair": start("-m", "torch.distributed.run", "--standalone",
                           "--nproc-per-node=2", WORKER, str(base / "multi")),
             "solo": start(WORKER, str(base / "solo"))}
    t0 = time.perf_counter()
    jax_hist = _jax_canonical_history()
    outs = {}
    try:
        for name, p in procs.items():
            left = max(1.0, WAIT_S - (time.perf_counter() - t0))
            outs[name] = p.communicate(timeout=left)[0]
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()
    for name, p in procs.items():
        assert p.returncode == 0, f"{name} failed:\n{outs[name][-4000:]}"
    w0, w1 = (_result(base / "multi", r, outs["pair"]) for r in (0, 1))
    assert (w0["rank"], w1["rank"]) == (0, 1)
    return {"base": base, "jax": jax_hist, "stdout": outs, "w0": w0,
            "w1": w1, "solo": _result(base / "solo", 0, outs["solo"])}


def _sum(a: dict, b: dict) -> dict:
    return {k: a[k] + b[k] for k in a}


def _traffic(*recs) -> dict:
    """The bytes the transport copied, by (source, destination) position,
    added up over the runs `recs`."""
    out: dict = {}
    for rec in recs:
        for src, dst, n in rec["traffic"]:
            out[(src, dst)] = out.get((src, dst), 0) + n
    return out


def _bytes_between(traffic: dict, owners) -> int:
    """The bytes a layout of the mesh positions over processes (`owners[p]`
    the process of position p) sends between processes for the copies of
    `traffic`: a copy from a whole level none (every process holds it),
    into a whole level once to each process but the source's owner, else
    once where the two positions' owners differ."""
    nprocs = max(owners) + 1
    tot = 0
    for (src, dst), n in traffic.items():
        if src == transport.WHOLE:
            continue
        if dst == transport.WHOLE:
            tot += n * (nprocs - 1)
        elif owners[src] != owners[dst]:
            tot += n
    return tot


# -------------------------------------------------------- two processes


def test_bootstrap_logs_and_mesh(runs):
    """Each process writes its log lines to its own pout.<n> and process 0
    mirrors its own to stdout; the mesh is process-major over the two
    processes' positions, each process's home its first, and each holds
    its own shards alone."""
    base = runs["base"]
    for i in range(2):
        txt = (base / "multi" / f"p{i}" / f"pout.{i}").read_text()
        assert f"process {i}/2 up" in txt
        assert "writes done" in txt
        assert "sharding over 4 devices (host-major mesh, shape " \
               "{'x': 2, 'y': 2})" in txt
        assert "The norm of dpsi after step 3" in txt
        assert "sharding over 2 devices (host-major mesh, shape " \
               "{'x': 2})" in txt
    assert "process 0/2 up" in runs["stdout"]["pair"]
    assert "process 1/2 up" not in runs["stdout"]["pair"]
    assert not (base / "multi" / "p0" / "pout.1").exists()
    for i, name in enumerate(("w0", "w1")):
        m = runs[name]["mesh"]
        assert m["owners"] == OWNERS and m["shape"] == {"x": 4}
        assert m["home_position"] == 2 * i
        assert runs[name]["io"]["held"] == [[[2 * i, 0, 0],
                                             [2 * i + 1, 0, 0]]] * 3
    assert runs["solo"]["mesh"]["owners"] == [0] * 4


def test_coordinator_alone_writes_files(runs):
    """The coordinator wrote the writers' files and main.run's plotfiles
    and checkpoint; the other process drained the same tiles (every one
    assembled on the coordinator) and wrote no file."""
    multi = runs["base"] / "multi"
    main_files = ["vcPoissonFinal.3d.hdf5"] + [
        f"vcPoissonOut.3d_{i}.hdf5" for i in range(3)]
    assert runs["w0"]["io"]["io_files"] == sorted(
        ["vcPoissonFinal.3d.hdf5", "vcPoissonOut.3d_0.hdf5"])
    assert runs["w1"]["io"]["io_files"] == []
    assert set(main_files) <= set(runs["w0"]["files"])
    assert not [f for f in runs["w1"]["files"] if f.endswith(".hdf5")]
    assert set(main_files) == set(runs["w0"]["entry_files"])
    assert runs["w1"]["entry_files"] == []
    assert not list((multi / "p1").rglob("*.hdf5"))
    w0, w1 = runs["w0"]["io"], runs["w1"]["io"]
    assert w0["tiles"] == w1["tiles"] == w0["assembled"] > 10
    assert w1["assembled"] == 0
    assert runs["solo"]["io"]["tiles"] == w0["tiles"]


def _datasets(path) -> dict:
    out = {}
    with h5py.File(path, "r") as f:
        f.visititems(lambda name, obj: out.__setitem__(name, obj[()])
                     if isinstance(obj, h5py.Dataset) else None)
    return out


@pytest.mark.parametrize("name", [
    "io/vcPoissonOut.3d_0.hdf5", "io/vcPoissonFinal.3d.hdf5",
    "vcPoissonOut.3d_0.hdf5", "vcPoissonOut.3d_2.hdf5",
    "vcPoissonFinal.3d.hdf5", "entry/vcPoissonOut.3d_2.hdf5",
    "entry/vcPoissonFinal.3d.hdf5"])
def test_files_equal_one_process(runs, name):
    """Every dataset of the coordinator's file is the one-process run's
    bit for bit."""
    got = _datasets(runs["base"] / "multi" / "p0" / name)
    want = _datasets(runs["base"] / "solo" / "p0" / name)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].tobytes() == want[k].tobytes(), k


def test_gathered_values_equal_global_arrays(runs):
    """The gathered values are the global arrays, the forest's two sibling
    patches each with its own (entry e = 1, 2), as the JAX package's
    two-process test reads them."""
    from mg_ic_code_tpu_torch.io import chombo_hdf5 as io

    d = runs["base"] / "multi" / "p0" / "io"
    box, _, _, named = io.read_level_data(str(d / "vcPoissonOut.3d_0.hdf5"),
                                          0)
    assert box.shape == (32, 32, 32)
    np.testing.assert_array_equal(named["dpsi"], 0.5)
    boxes, _, _, patches = io.read_level_patches(
        str(d / "vcPoissonOut.3d_0.hdf5"), 1)
    assert [b.shape for b in boxes] == [(32, 16, 16)] * 2
    for e, named in zip((1, 2), patches):
        np.testing.assert_array_equal(named["dpsi"], 0.5 + e)
        np.testing.assert_array_equal(named["rhs"], 2.0 + e)
        np.testing.assert_array_equal(named["psi"], 1.0 + 0.01 * e)
    _, _, _, fnamed = io.read_level_data(str(d / "vcPoissonFinal.3d.hdf5"),
                                         0)
    assert set(fnamed) >= {"chi", "K", "lapse", "phi"}
    assert np.all(fnamed["chi"] > 0)


@pytest.mark.parametrize("run", RUNS[1:])
def test_solve_bit_for_bit_one_process(runs, run):
    """History, Krylov counts, K and every level of psi and dpsi of the
    two processes are the one process's over the same four positions, bit
    for bit (every reduction adds the same partials in the same order);
    the command line returned 0 on both."""
    want = runs["solo"][run]
    for name in ("w0", "w1"):
        got = runs[name][run]
        for k in ("history", "linear_iters", "constant_K", "psi", "dpsi"):
            assert got[k] == want[k], (name, k, got[k], want[k])
        assert got.get("rc", 0) == 0
    assert all(b < a for a, b in zip(want["history"], want["history"][1:]))


@pytest.mark.parametrize("run", ("canonical", "entry"))
def test_canonical_within_jax_limits(runs, run):
    """The canonical 3-level history (on the four positions' pencils, and
    through the entry on its two x-slabs) against the JAX package's
    single-process one on the CPU in x64: step 1 within 1e-10 relative,
    the history within 1e-3, the limits of the JAX package's own
    two-process test (readings: 4e-15 and 2e-5); equal Krylov counts."""
    jax_hist, jax_iters = runs["jax"]
    got = runs["w0"][run]
    assert len(got["history"]) == len(jax_hist) == 3
    np.testing.assert_allclose(got["history"][0], jax_hist[0], rtol=1e-10)
    np.testing.assert_allclose(got["history"], jax_hist, rtol=1e-3)
    assert got["linear_iters"] == list(jax_iters)


@pytest.mark.parametrize("run", RUNS)
def test_counts_add_up_to_one_process(runs, run):
    """HALO's counts of the two processes add up to the one process's
    (process 0 counts the events, the owner of a copy's destination its
    bytes), and so do the bytes by (source, destination); the bytes that
    crossed between the processes are those the layout of the positions
    implies for the one process's copies (_bytes_between), and more than
    none."""
    w0, w1, solo = (runs[n][run] for n in ("w0", "w1", "solo"))
    got = _sum(w0["halo"], w1["halo"])
    between = _bytes_between(_traffic(solo),
                             ENTRY_OWNERS if run == "entry" else OWNERS)
    assert between > 0
    assert got["bytes_between_processes"] == between
    assert got["messages"] > 0
    assert solo["halo"]["bytes_between_processes"] == 0
    assert solo["halo"]["messages"] == 0
    assert {k: got[k] for k in kernel_counts.HALO_COUNTS[:-2]} == {
        k: solo["halo"][k] for k in kernel_counts.HALO_COUNTS[:-2]}
    assert _traffic(w0, w1) == _traffic(solo)


def test_a_process_without_shards(runs):
    """The y-cut box cuts every depth along y alone, at positions 0 and 1:
    the second process holds none of its shards, launches none of its
    shard kernels, and still reads the same bits."""
    w1 = runs["w1"]["periodic_ycut"]
    assert w1["plain_calls"]["multisweep_relax_tiled_pre"] == 0
    assert runs["w0"]["periodic_ycut"]["plain_calls"][
        "multisweep_relax_tiled_pre"] == runs["solo"]["periodic_ycut"][
        "plain_calls"]["multisweep_relax_tiled_pre"] > 0
    assert w1["history"] == runs["solo"]["periodic_ycut"]["history"]


@pytest.mark.parametrize("run", ("periodic_x", "periodic_pencil"))
def test_kernel_calls_add_up(runs, run):
    """The kernels' calls (their plain versions on the CPU): the shard
    kernels' calls of the two processes add up to the one process's;
    every other kernel runs whole on each process, as often as on one."""
    w0, w1, solo = (runs[n][run]["plain_calls"] for n in ("w0", "w1",
                                                          "solo"))
    kernel = {"periodic_x": "multisweep_relax_halo",
              "periodic_pencil": "multisweep_relax_tiled_pre"}[run]
    assert w0[kernel] > 0 and w1[kernel] > 0
    for k in kernel_counts.KERNELS:
        if k in SHARD_KERNELS:
            assert w0[k] + w1[k] == solo[k], k
        else:
            assert w0[k] == w1[k] == solo[k], k


def test_forest_pair_on_two_processes(runs):
    """The forest's batch group (1, 2) sits at positions 0 and 2 of its
    (2, 1, 2) mesh, one patch on each process: each process launches the
    batched kernels (their plain versions) for its own patch only, the
    two add up to the one process's calls, the solution is the one
    process's bit for bit, and HALO (the patch moves included) and the
    bytes by (source, destination) add up to its counts."""
    w0, w1, solo = (runs[n]["forest"] for n in ("w0", "w1", "solo"))
    assert solo["batch_groups"] == [[1, 2]] and solo["positions"] == [0, 2]
    assert [w0["owners"][p] for p in w0["positions"]] == [0, 1]
    for got in (w0, w1):
        assert got["x"] == solo["x"]
        assert got["linear_iters"] == solo["linear_iters"]
    for k in ("gsrb_relax_batch", "residual_restrict_batch"):
        assert w0["plain_calls"][k] > 0 and w1["plain_calls"][k] > 0
        assert w0["plain_calls"][k] + w1["plain_calls"][k] == \
            solo["plain_calls"][k], k
    got = _sum(w0["halo"], w1["halo"])
    assert got["patch_moves"] == solo["halo"]["patch_moves"] > 0
    assert {k: got[k] for k in kernel_counts.HALO_COUNTS[:-2]} == {
        k: solo["halo"][k] for k in kernel_counts.HALO_COUNTS[:-2]}
    assert _traffic(w0, w1) == _traffic(solo)
    assert got["bytes_between_processes"] == _bytes_between(
        _traffic(solo), OWNERS) > 0


def test_plans_identical_on_every_process(runs):
    """Every plan of copies (its sources and destinations, in order) is the
    same on both processes and the one process's, the process that holds
    no shard of the y-cut box's levels included: each derives it from the
    layout alone."""
    for run in RUNS + ("forest",):
        want = runs["solo"][run]
        assert want["plans"] > 0
        for name in ("w0", "w1"):
            got = runs[name][run]
            assert (got["plans"], got["digest"]) == (want["plans"],
                                                     want["digest"]), run


# ------------------------------------------------------------ in process


def test_initialize_is_a_noop_on_one_process(monkeypatch):
    """No arguments and no torchrun environment, WORLD_SIZE 1, or one
    process asked for: nothing starts, and asking again changes
    nothing."""
    for key in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(key, raising=False)
    tdist.initialize()
    tdist.initialize()
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    tdist.initialize()
    tdist.initialize("localhost:1", num_processes=1, process_id=0)
    assert not tdist.is_initialized()
    assert (tdist.process_index(), tdist.process_count()) == (0, 1)
    assert tdist.is_coordinator() and tdist.agree_max(3) == 3
    tdist.finalize()


def test_initialize_refuses_what_it_cannot_start():
    """Several processes asked for without the coordinator or the index
    raise; so does NCCL without a CUDA device (no quiet switch to gloo)."""
    with pytest.raises(ValueError):
        tdist.initialize(num_processes=2)
    with pytest.raises(ValueError):
        tdist.initialize("localhost:1", num_processes=2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="name backend='gloo'"):
            tdist.initialize("localhost:1", num_processes=2, process_id=0)
    assert not tdist.is_initialized()


def test_check_distinct_cards():
    """Each process's card UUID through the store: distinct cards pass,
    two processes on one card raise the port's error."""
    import torch.distributed as dist

    store = dist.HashStore()
    store.set("mg_ic_card_1", "GPU-b")
    tdist.check_distinct_cards(store, 0, 2, "GPU-a", timeout=5)
    store = dist.HashStore()
    other = threading.Thread(target=lambda: store.set("mg_ic_card_1",
                                                      "GPU-a"))
    other.start()
    with pytest.raises(tdist.SharedCardError, match="one card"):
        tdist.check_distinct_cards(store, 0, 2, "GPU-a", timeout=5)
    other.join()


def test_nccl_on_a_shared_card_raises(monkeypatch):
    """initialize with NCCL compares the processes' cards before NCCL
    builds a communicator, and leaves the group again where two share
    one (the cards' UUIDs and the group stand in for a second process)."""
    import torch.distributed as dist
    import torch.distributed.distributed_c10d as c10d

    store = dist.HashStore()
    store.set("mg_ic_card_1", "GPU-same")
    calls = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda i: calls.append(("set_device", i)))
    monkeypatch.setattr(dist, "init_process_group",
                        lambda *a, **kw: calls.append(("init", a[0])))
    monkeypatch.setattr(dist, "destroy_process_group",
                        lambda: calls.append(("destroy",)))
    monkeypatch.setattr(c10d, "_get_default_store", lambda: store)
    monkeypatch.setattr(tdist, "card_uuid", lambda i: "GPU-same")
    with pytest.raises(tdist.SharedCardError):
        tdist.initialize("localhost:1", num_processes=2, process_id=0,
                         local_rank=0, timeout=5)
    assert calls == [("set_device", 0), ("init", "nccl"), ("destroy",)]


def test_mesh_owners_are_process_major():
    """A mesh's positions are process-major; a process's home is its first
    position, and only its own positions are local."""
    m = tmesh.make_mesh(["cpu"] * 4, (2, 2), owners=(0, 0, 1, 1), rank=1)
    assert (m.nprocs, m.home_position, m.home) == (2, 2, torch.device("cpu"))
    assert [m.is_local(p) for p in range(4)] == [False, False, True, True]
    one = tmesh.make_mesh(["cpu"] * 4, (2, 2))
    assert one.owners == (0,) * 4 and one.home_position == 0
    with pytest.raises(ValueError):
        tmesh.make_mesh(["cpu"] * 4, (4,), owners=(0, 1, 0, 1))
    with pytest.raises(ValueError):
        tmesh.make_mesh(["cpu"] * 4, (4,), owners=(0, 0, 1, 1), rank=2)


def test_exchange_on_one_process():
    """On one process every transfer of a plan is a copy, in the plan's
    order; bytes_moved counts those between two positions (a whole level
    at position 0), none where the caller says they move nothing (the
    writers' tiles) or where there is no mesh; nothing crosses between
    processes."""
    w = transport.WHOLE
    m = tmesh.make_mesh(["cpu"] * 2, (2,))
    data = {0: torch.arange(4.0), 1: torch.arange(4.0, 8.0),
            w: torch.arange(8.0, 10.0, dtype=torch.float64)}
    got = []

    def put(t):
        got.append(t.tolist())

    plan = [transport.Transfer(src, dst, tuple(data[src].shape),
                               data[src].dtype, lambda src=src: data[src],
                               put)
            for src, dst in ((1, 0), (0, 1), (1, 1), (w, 0), (w, 1),
                             (0, w), (1, w))]
    kernel_counts.reset()
    transport.exchange(m, plan)
    want = [data[t.src].tolist() for t in plan]
    assert got == want
    halo = kernel_counts.HALO
    assert halo["bytes_moved"] == 16 + 16 + 16 + 16
    assert halo["bytes_between_processes"] == halo["messages"] == 0
    got.clear()
    kernel_counts.reset()
    transport.exchange(m, plan, moved=False)
    transport.exchange(None, plan)
    assert got == want + want and halo["bytes_moved"] == 0


def test_kernel_build_is_locked(tmp_path):
    """Processes (here threads, each with its own open of the lock file)
    that reach the build at once: one builds, the others wait and find
    the library built."""
    path = str(tmp_path / "libmgk_test.so")
    builds, results = [], []

    def build(p):
        builds.append(p)
        time.sleep(0.3)
        with open(p, "w") as f:
            f.write("lib")
        return "log"

    n = 2 * (os.cpu_count() or 4)  # more builders than cores
    threads = [threading.Thread(target=lambda: results.append(
        cuda_ext.locked_build(path, build))) for _ in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    assert builds == [path]
    assert sorted(results) == [(False, "log")] + [(True, None)] * (n - 1)
    assert cuda_ext.locked_build(path, build) == (True, None)
    assert os.path.exists(path + ".lock")


def test_process_group_timeout_is_explicit():
    """The start-up and message timeout is the port's (two minutes at
    most), not gloo's half hour."""
    assert tdist.TIMEOUT_S <= 120
    assert datetime.timedelta(seconds=tdist.TIMEOUT_S) < \
        datetime.timedelta(minutes=30)
