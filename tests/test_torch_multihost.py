"""The port's multi-process runs (``parallel/multihost.py``, a mesh that
spans processes) on the CPU.

Detection, the nodelist parser and the backend rule are pure functions of
the environment, tested with mocked ones (the counterparts of
tests/test_multihost.py; R1, a malformed integer, warns and stays single-
process instead of crashing).  The sharded path runs in two processes on
the CPU with the gloo backend: each case goes through the library in two
processes started with the explicit ``MASTER_ADDR`` form, and through the
CLI under ``torch.distributed.run``.  A run across processes is held
bitwise to the single-process run on the same mesh shape (the halos are
the same rows, the ||u|| sums are added in the same shard order), and
within rtol 1e-5 / atol 1e-7 (f) and rtol 1e-5 (av) to the JAX package's
sharded run on its virtual CPU devices, as tests/test_torch_sharded.py
holds the single-process path.  A process that leaves the group standing
exits 0: the library takes it down at exit.  The staging rule (buffers on
the card under nccl, on the host under gloo) and the order in which each
rank posts an exchange's sends and receives are checked in one process,
with the transfers delivered by hand in the order nccl pairs them (the
order a pair of ranks posts them, tags ignored).
"""

import json
import os
import socket
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from advanced_hpc_lbm_tpu.ops import reference as jref
from advanced_hpc_lbm_tpu.parallel import halo as jhalo
from advanced_hpc_lbm_tpu.params import LBMParams as JaxParams
from advanced_hpc_lbm_tpu_torch import Simulation, cli
from advanced_hpc_lbm_tpu_torch.parallel import halo, mesh, multihost
from advanced_hpc_lbm_tpu_torch.params import LBMParams
from advanced_hpc_lbm_tpu_torch.utils import check, io

F_TOL = dict(rtol=1e-5, atol=1e-7)
AV_RTOL = 1e-5
ROOT = Path(__file__).resolve().parent.parent
MINI = (str(ROOT / "decks/mini_64x64.params"), str(ROOT / "decks/mini_64x64.obstacles.dat"))
MINI_GOLDEN = str(ROOT / "decks/mini_64x64.golden_av_vels.dat")
TIMEOUT_S = 120  # each two-process launch; a deadlock fails here, not at the suite's limit
CHILD_THREADS = 1  # intra-op threads of every run compared bitwise with a child's


def make_case(ny, nx, seed=7):
    """Walls on rows 0 and ny-1, a block, random obstacles; equilibrium x
    uniform(0.8, 1.2), with W starved on half of row ny-2 so that the
    forcing guard fails there (tests/test_torch_sharded.py's case)."""
    jp = JaxParams(nx=nx, ny=ny, max_iters=40, reynolds_dim=10,
                   density=0.1, accel=0.005, omega=1.85)
    rng = np.random.RandomState(seed)
    mask = np.zeros((ny, nx), dtype=bool)
    mask[0] = mask[-1] = True
    mask[ny // 3: ny // 3 + 2, nx // 4: nx // 2] = True
    for _ in range(8):
        mask[rng.randint(1, ny - 1), rng.randint(0, nx)] = True
    f0 = np.asarray(jref.initial_state(jp)) * rng.uniform(
        0.8, 1.2, (9, ny, nx)).astype(np.float32)
    f0[3, ny - 2, : nx // 2] = jp.accel_w1 * np.float32(0.5)
    return jp, mask, f0


# ---- detection ----------------------------------------------------------------------

@pytest.mark.parametrize("env,want", [
    ({}, None),
    ({"MASTER_ADDR": "10.0.0.1", "MASTER_PORT": "1234", "WORLD_SIZE": "4", "RANK": "2"},
     {"init_method": "tcp://10.0.0.1:1234", "world_size": 4, "rank": 2}),
    ({"MASTER_ADDR": "head", "MASTER_PORT": "99", "SLURM_NTASKS": "8", "SLURM_PROCID": "5"},
     {"init_method": "tcp://head:99", "world_size": 8, "rank": 5}),
    ({"MASTER_ADDR": "head", "WORLD_SIZE": "2", "RANK": "1"},
     {"init_method": "tcp://head:29500", "world_size": 2, "rank": 1}),
    ({"MASTER_ADDR": "head", "WORLD_SIZE": "1", "RANK": "0"}, None),
    ({"SLURM_NTASKS": "4", "SLURM_PROCID": "3", "SLURM_STEP_NODELIST": "gpu-node[07-10]"},
     {"init_method": "tcp://gpu-node07:29500", "world_size": 4, "rank": 3}),
    ({"SLURM_NTASKS": "2", "SLURM_PROCID": "1", "SLURM_JOB_NODELIST": "a,b",
      "MASTER_PORT": "4000"},
     {"init_method": "tcp://a:4000", "world_size": 2, "rank": 1}),
    ({"SLURM_NTASKS": "1"}, None),
    ({"TPU_WORKER_HOSTNAMES": "w0,w1,w2,w3"}, None),
], ids=["empty", "explicit", "explicit-slurm-ranks", "explicit-default-port", "explicit-one",
        "slurm-multitask", "slurm-job-nodelist", "slurm-single-task", "tpu-pod-hosts"])
def test_detect(env, want):
    assert multihost.detect(env) == want


@pytest.mark.parametrize("env", [
    {"SLURM_NTASKS": "four"},
    {"MASTER_ADDR": "head", "WORLD_SIZE": "2x", "RANK": "0"},
    {"MASTER_ADDR": "head", "WORLD_SIZE": "2", "RANK": "first"},
    {"SLURM_NTASKS": "2", "SLURM_PROCID": "?", "SLURM_STEP_NODELIST": "n1"},
    {"MASTER_ADDR": "head", "WORLD_SIZE": "2", "RANK": "0", "MASTER_PORT": "http"},
], ids=["slurm-ntasks", "world-size", "rank", "slurm-procid", "master-port"])
def test_malformed_integer_warns_and_stays_single_process(env):
    """Fault R1 of the JAX module (a bare int() of the environment) is not
    copied: a malformed integer warns, and the run is single-process."""
    with pytest.warns(UserWarning, match="not an integer"):
        assert multihost.detect(env) is None


@pytest.mark.parametrize("nodelist,first", [
    ("n[3-7,9]", "n3"), ("gpu[12,15]", "gpu12"), ("alpha,beta", "alpha"), ("solo", "solo"),
])
def test_first_slurm_host(nodelist, first):
    assert multihost._first_slurm_host(nodelist) == first


@pytest.mark.parametrize("device_type,local,cards,want", [
    ("cuda", 1, 1, "nccl"), ("cuda", 8, 8, "nccl"), ("cuda", 4, 8, "nccl"),
    ("cuda", 2, 1, "gloo"),  # two processes share the one card
    ("cuda", 1, 0, "gloo"), ("cpu", 2, 8, "gloo"), ("cpu", 1, 0, "gloo"),
])
def test_backend_rule(device_type, local, cards, want):
    assert multihost.choose_backend(device_type, local, cards) == want


@pytest.mark.parametrize("env,world,want", [
    ({"LOCAL_WORLD_SIZE": "2"}, 4, 2), ({"SLURM_NTASKS_PER_NODE": "14"}, 28, 14),
    ({"SLURM_TASKS_PER_NODE": "28(x2)"}, 56, 28), ({}, 3, 3),
])
def test_local_world_size(env, world, want):
    assert multihost.local_world_size(env, world) == want


def test_local_rank_and_malformed_local_rank():
    assert multihost.local_rank({"LOCAL_RANK": "3"}) == 3
    assert multihost.local_rank({"SLURM_LOCALID": "1"}) == 1
    with pytest.warns(UserWarning):
        assert multihost.local_rank({"LOCAL_RANK": "x"}) == 0


def test_single_process_is_a_no_op():
    """A single-process environment forms no group, and every query answers
    for one process."""
    assert multihost.maybe_initialize({}) is False
    assert multihost.process_count() == 1 and multihost.process_index() == 0
    assert multihost.is_primary() and multihost.backend() is None
    assert str(multihost.local_device("cpu")) == "cpu"
    with multihost.primary_first():
        pass


def test_checkpoint_is_refused_across_processes(monkeypatch, tmp_path):
    """A checkpointed run under more than one process is refused before any
    step (the JAX snapshot cannot gather a state that spans processes)."""
    jp, mask, _ = make_case(32, 32)
    sim = Simulation(LBMParams.from_jax(jp), mask, device="cpu")
    monkeypatch.setattr(multihost, "process_count", lambda: 2)
    for kw in ({"checkpoint_every": 2}, {"resume": True}):
        with pytest.raises(ValueError, match="single process"):
            sim.warmup(n_iters=4, checkpoint_dir=str(tmp_path), **kw)
        with pytest.raises(ValueError, match="single process"):
            sim.run(n_iters=4, checkpoint_dir=str(tmp_path), **kw)
    assert not list(tmp_path.iterdir())


# ---- the exchange across processes: staging and order ------------------------------------

@pytest.mark.parametrize("backend,where", [("nccl", "cuda:1"), ("gloo", "cpu"), (None, "cpu")])
def test_staging_device_follows_the_backend(monkeypatch, backend, where):
    """A card's rows pass through the process group from buffers on the card
    under nccl, from host buffers under gloo (which moves host tensors
    only); a CPU shard's stay on the CPU."""
    monkeypatch.setattr(multihost, "backend", lambda: backend)
    assert halo._stage_device(torch.device("cuda", 1)) == torch.device(where)
    assert halo._stage_device(torch.device("cpu")) == torch.device("cpu")


class _P2POp:
    """What a ``torch.distributed.P2POp`` carries, without a process group."""

    def __init__(self, op, tensor, peer, tag=0):
        self.op, self.tensor, self.peer, self.tag = op, tensor, peer, tag


PHASE_MESHES = {  # name: (mesh shape, torus, owning rank of each shard, ghost depth)
    "ring of 2 over 2": ((2, 1), False, (0, 1), 1),
    "ring of 4 over 4": ((4, 1), False, (0, 1, 2, 3), 1),
    "ring of 4 over 2, K=2": ((4, 1), False, (0, 0, 1, 1), 2),
    "torus 2x2 over 4": ((2, 2), True, (0, 1, 2, 3), 1),
    "torus 2x1 over 2": ((2, 1), True, (0, 1), 1),
    "torus 1x2 over 2": ((1, 2), True, (0, 1), 1),
    "torus 2x4 over 4": ((2, 4), True, (0, 0, 1, 1, 2, 2, 3, 3), 1),
    "torus 2x2 over 4, K=8": ((2, 2), True, (0, 1, 2, 3), 8),
}


@pytest.mark.parametrize("name", list(PHASE_MESHES))
def test_remote_copies_pair_up_in_posting_order(monkeypatch, name):
    """Each rank posts the remote copies of an exchange phase in the
    phase's one global order, so a backend that pairs a send with a
    receive by the order a pair of ranks posts them, ignoring tags (nccl),
    pairs them right: for every ordered pair of ranks the sender's sends to
    the receiver and the receiver's receives from the sender carry the same
    (tag, shape) sequence, on a torus too, where a pair exchanges rows and
    then columns (twice each where the mesh has 2 rows or columns).
    Delivered in that order, phase after phase, the ranks' windows equal
    one process's after its exchange, ghost cells and corners included."""
    (my, mx), torus, ranks, g = PHASE_MESHES[name]
    ly = lx = 2 * g + 2
    ny, nx = my * ly, mx * lx
    f0 = torch.from_numpy(np.random.RandomState(3).rand(9, ny, nx).astype(np.float32))
    devices = (torch.device("cpu"),) * len(ranks)
    posted = []
    monkeypatch.setattr(torch.distributed, "P2POp", _P2POp)
    monkeypatch.setattr(torch.distributed, "batch_isend_irecv",
                        lambda ops: posted.append(ops) or [])

    def windows(rank, owners):
        monkeypatch.setattr(multihost, "process_index", lambda: rank)
        win = halo._Windows(mesh.Mesh(devices, (my, mx), torus, owners), ny, nx, g)
        win.load(None, f0)
        return win

    wins = {r: windows(r, ranks) for r in sorted(set(ranks))}
    one = windows(0, ())
    one.exchange(0)
    n_remote = 0
    for p in range(len(one.phases[0])):
        ops = {}
        for r, win in wins.items():
            phase = win.phases[0][p]
            for dst, src in phase.local:
                dst.copy_(src)
            posted.clear()
            phase.post()
            ops[r] = posted[0] if posted else []
            n_remote += len(ops[r])
            assert [op.tag for op in ops[r]] == sorted(op.tag for op in ops[r])
        for a in wins:
            for b in wins:
                sends = [op for op in ops[a] if op.op is torch.distributed.isend and op.peer == b]
                recvs = [op for op in ops[b] if op.op is torch.distributed.irecv and op.peer == a]
                assert ([(op.tag, op.tensor.shape) for op in sends]
                        == [(op.tag, op.tensor.shape) for op in recvs])
                for s, r in zip(sends, recvs):
                    r.tensor.copy_(s.tensor)
        for win in wins.values():
            win.phases[0][p].land([])
    assert n_remote > 0
    for win in wins.values():
        for s in win.local:
            assert torch.equal(win.bufs[0][s], one.bufs[0][s])


# ---- two processes: the library -------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(argvs: list[list[str]], env_of, cwd) -> list[subprocess.CompletedProcess]:
    """Start one process per argv with env_of(rank); wait at most TIMEOUT_S
    for all of them, killing every one on a timeout."""
    procs = [subprocess.Popen(argv, cwd=cwd, env=env_of(r), stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r, argv in enumerate(argvs)]
    deadline = time.monotonic() + TIMEOUT_S
    try:
        outs = [p.communicate(timeout=max(0.0, deadline - time.monotonic())) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return [subprocess.CompletedProcess(p.args, p.returncode, o, e)
            for p, (o, e) in zip(procs, outs)]


def _base_env() -> dict:
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK",
                        "LOCAL_WORLD_SIZE", "SLURM_NTASKS", "SLURM_PROCID")}
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    # the plain versions' CPU sums split over the threads: a small fixed
    # count, the same in every run that a test compares bitwise, so that
    # the runs add in the same order (and two children beside a loaded
    # host's other workers do not each ask for every core)
    env["OMP_NUM_THREADS"] = str(CHILD_THREADS)
    return env


# each process runs every configuration on its own shards (``shards`` //
# 2 of them, on the CPU) and saves the gathered state, av and densities
WORKER = r"""
import json, sys
import numpy as np
from advanced_hpc_lbm_tpu_torch.parallel import halo, multihost
from advanced_hpc_lbm_tpu_torch.params import LBMParams

out = sys.argv[1]
assert multihost.maybe_initialize()
rank, world = multihost.process_index(), multihost.process_count()
case = np.load(out + "/case.npz")
params = LBMParams(**json.loads(str(case["params"])))
for name, kw in json.loads(str(case["configs"])).items():
    kw = dict(kw)
    devices = ["cpu"] * (kw.pop("shards") // world)
    if "mesh" in kw:
        res = halo.run_sharded_2d(case["f0"], case["mask"], params, tuple(kw.pop("mesh")),
                                  devices=devices, **kw)
    else:
        res = halo.run_sharded(case["f0"], case["mask"], params, devices=devices, **kw)
    np.savez(f"{out}/{name}.{rank}.npz", f=res[0].numpy(), av=res[1].numpy(),
             dens=res[2].numpy() if len(res) > 2 else np.zeros(0),
             ranks=np.array(res[0].mesh.ranks), backend=multihost.backend())
"""

# name -> run keywords: shards over the two processes (an equal share each)
CONFIGS = {
    "jnp": {"shards": 2, "n_iters": 7},
    "pallas": {"shards": 2, "n_iters": 7, "kernel": "pallas"},
    "overlap": {"shards": 2, "n_iters": 7, "overlap": True},
    "pallas_k2": {"shards": 2, "n_iters": 7, "kernel": "pallas", "ca_steps": 2},
    "stream": {"shards": 2, "n_iters": 9, "kernel": "stream"},
    # two shards per process: local pairs beside remote ones, debug sums
    "jnp_k2_four": {"shards": 4, "n_iters": 7, "ca_steps": 2, "collect_density": True},
    "pallas_debug_four": {"shards": 4, "n_iters": 5, "kernel": "pallas",
                          "collect_density": True},
    # tori: rows across processes (2x1), columns across processes (2x2,
    # row-major: process 0 holds the first row of shards)
    "torus_2x1": {"shards": 2, "n_iters": 7, "mesh": [2, 1], "kernel": "pallas"},
    "torus_2x2": {"shards": 4, "n_iters": 7, "mesh": [2, 2], "kernel": "pallas"},
    "torus_2x2_stream": {"shards": 4, "n_iters": 9, "mesh": [2, 2], "kernel": "stream"},
}


@pytest.fixture(scope="module")
def two_process_runs(tmp_path_factory):
    """Every configuration run by two processes on the CPU (gloo), once."""
    out = tmp_path_factory.mktemp("mp")
    jp, mask, f0 = make_case(32, 128, seed=41)
    params = LBMParams.from_jax(jp)
    np.savez(out / "case.npz", f0=f0, mask=mask,
             params=json.dumps({k: getattr(params, k) for k in
                                ("nx", "ny", "max_iters", "reynolds_dim", "density",
                                 "accel", "omega")}),
             configs=json.dumps(CONFIGS))
    port = _free_port()

    def env_of(rank):
        return {**_base_env(), "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
                "WORLD_SIZE": "2", "RANK": str(rank), "LOCAL_RANK": str(rank),
                "LOCAL_WORLD_SIZE": "2"}

    procs = _launch([[sys.executable, "-c", WORKER, str(out)]] * 2, env_of, ROOT)
    for p in procs:
        assert p.returncode == 0, p.stderr[-3000:]
    return jp, mask, f0, {name: [dict(np.load(out / f"{name}.{r}.npz")) for r in range(2)]
                          for name in CONFIGS}


def _single_process(params, mask, f0, kw):
    kw = dict(kw)
    devices = ["cpu"] * kw.pop("shards")
    # the children's thread count, so that the sums add as theirs do;
    # restored after, so that no other case of this worker changes
    threads = torch.get_num_threads()
    torch.set_num_threads(CHILD_THREADS)
    try:
        if "mesh" in kw:
            res = halo.run_sharded_2d(f0, mask, params, tuple(kw.pop("mesh")), devices=devices,
                                      **kw)
        else:
            res = halo.run_sharded(f0, mask, params, devices=devices, **kw)
    finally:
        torch.set_num_threads(threads)
    return res[0].numpy(), *(r.numpy() for r in res[1:])


@pytest.mark.parametrize("name", list(CONFIGS))
def test_two_processes_equal_one_process_bitwise(two_process_runs, name):
    jp, mask, f0, runs = two_process_runs
    kw = CONFIGS[name]
    got = runs[name]
    shards = kw["shards"]
    assert list(got[0]["ranks"]) == [0] * (shards // 2) + [1] * (shards // 2)
    assert str(got[0]["backend"]) == "gloo"
    want = _single_process(LBMParams.from_jax(jp), mask, f0, kw)
    for r in range(2):  # every process gets the whole state and the sums
        np.testing.assert_array_equal(got[r]["f"], want[0])
        np.testing.assert_array_equal(got[r]["av"], want[1])
        if kw.get("collect_density"):
            np.testing.assert_array_equal(got[r]["dens"], want[2])


# the JAX package's counterpart of each configuration (its kernels in
# interpret mode)
JAX_KW = {
    "jnp": {}, "pallas": {"kernel": "pallas", "interpret": True}, "overlap": {"overlap": True},
    "pallas_k2": {"kernel": "pallas", "ca_steps": 2, "interpret": True},
    "torus_2x1": {"kernel": "pallas", "interpret": True},
}


@pytest.mark.parametrize("name", list(JAX_KW))
def test_two_processes_match_jax(two_process_runs, name):
    jp, mask, f0, runs = two_process_runs
    kw = CONFIGS[name]
    args = (jnp.asarray(f0), jnp.asarray(mask), jp)
    if "mesh" in kw:
        ref = jhalo.run_sharded_2d(*args, tuple(kw["mesh"]), n_iters=kw["n_iters"],
                                   **JAX_KW[name])
    else:
        ref = jhalo.run_sharded(*args, n_iters=kw["n_iters"], n_devices=kw["shards"],
                                **JAX_KW[name])
    np.testing.assert_allclose(runs[name][0]["f"], np.asarray(ref[0]), **F_TOL)
    np.testing.assert_allclose(runs[name][0]["av"], np.asarray(ref[1]), rtol=AV_RTOL)


# ---- exit: a group left standing -------------------------------------------------------

# forms the group, runs checked collectives and returns without tearing the
# group down; four more all_reduces are left in flight, so that the exit
# meets the group's worker threads at work
EXIT_WORKER = r"""
import torch
import torch.distributed as dist
from advanced_hpc_lbm_tpu_torch.parallel import multihost

assert multihost.maybe_initialize(device_type="cpu")
world = multihost.process_count()
x = torch.ones(64)
for _ in range(20):
    dist.all_reduce(x)
    x /= world
assert world == 2 and bool((x == 1).all())
for _ in range(4):
    dist.all_reduce(torch.ones_like(x), async_op=True)
"""
EXIT_PAIRS = 8


@pytest.fixture(scope="module")
def exits_without_teardown():
    """EXIT_PAIRS launches of two processes, all started at once (so that
    they load the host as a busy suite does), each launch with its own time
    limit; the CompletedProcesses of each launch."""
    def pair(_):
        port = _free_port()

        def env_of(rank):
            return {**_base_env(), "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
                    "WORLD_SIZE": "2", "RANK": str(rank)}

        return _launch([[sys.executable, "-c", EXIT_WORKER]] * 2, env_of, ROOT)

    with ThreadPoolExecutor(EXIT_PAIRS) as pool:
        return list(pool.map(pair, range(EXIT_PAIRS)))


@pytest.mark.parametrize("pair", range(EXIT_PAIRS))
def test_group_left_standing_exits_cleanly(exits_without_teardown, pair):
    """Every process of a launch whose script leaves the group standing
    exits 0: the library takes the group down at exit (left to the
    interpreter's exit, most processes of this setting died of SIGABRT
    after their work)."""
    for p in exits_without_teardown[pair]:
        assert p.returncode == 0, p.stderr[-3000:]


def test_group_of_one_left_standing_exits_cleanly(tmp_path):
    """``maybe_initialize(force=True)`` with no launch in the environment
    forms a group of one process; returning without a teardown exits 0."""
    script = ("import torch, torch.distributed as dist\n"
              "from advanced_hpc_lbm_tpu_torch.parallel import multihost\n"
              "assert multihost.maybe_initialize(force=True, device_type='cpu')\n"
              "x = torch.ones(4)\n"
              "dist.all_reduce(x)\n"
              "assert multihost.process_count() == 1 and bool((x == 1).all())\n")
    res = subprocess.run([sys.executable, "-c", script], cwd=tmp_path, env=_base_env(),
                         capture_output=True, text=True, timeout=TIMEOUT_S)
    assert res.returncode == 0, res.stderr[-3000:]


# ---- two processes: the CLI under torch.distributed.run ------------------------------------

def _torchrun(args: list[str], cwd) -> list[subprocess.CompletedProcess]:
    """``python -m torch.distributed.run --standalone --nproc-per-node 2 -m
    advanced_hpc_lbm_tpu_torch *args``; one CompletedProcess (the launcher's
    output holds both ranks')."""
    argv = [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc-per-node", "2", "-m", "advanced_hpc_lbm_tpu_torch", *args]
    return _launch([argv], lambda _: _base_env(), cwd)[0]


@pytest.mark.parametrize("flags", [
    ["--backend", "sharded", "--devices", "2"],
    ["--mesh", "2x1", "--shard-kernel", "pallas"],
    ["--backend", "sharded", "--devices", "2", "--multihost"],
], ids=["ring-jnp", "torus-pallas", "ring-multihost"])
def test_cli_two_processes(flags, tmp_path):
    """One ==done== block, written once, and the outputs of the
    single-process run on the same mesh shape, byte for byte."""
    one, two = tmp_path / "one", tmp_path / "two"
    one.mkdir()
    two.mkdir()
    res = _torchrun([*MINI, "--device", "cpu", *flags, "--out-dir", str(two)], tmp_path)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.count("==done==") == 1 and res.stdout.count("Reynolds number") == 1
    rc = subprocess.run([sys.executable, "-m", "advanced_hpc_lbm_tpu_torch", *MINI, "--device",
                         "cpu", *[f for f in flags if f != "--multihost"],
                         "--out-dir", str(one)], cwd=tmp_path, env=_base_env(),
                        capture_output=True, text=True, timeout=TIMEOUT_S).returncode
    assert rc == 0
    for name in (io.FINAL_STATE_FILE, io.AV_VELS_FILE):
        assert (two / name).read_bytes() == (one / name).read_bytes()
    assert sorted(p.name for p in two.iterdir()) == [io.AV_VELS_FILE, io.FINAL_STATE_FILE]
    assert check.check_av_vels_only(MINI_GOLDEN, str(two / io.AV_VELS_FILE)).passed(1.0)


def test_cli_two_processes_unsharded_and_refusals(tmp_path):
    """``--multihost`` on a single-device backend: each process runs the
    deck, the primary prints and writes (the mini deck's golden at 1%);
    ``--debug`` prints its lines once.  A checkpointed run exits 1 on every
    process with the refusal and writes nothing."""
    res = _torchrun([*MINI, "--device", "cpu", "--multihost", "--debug", "--iters", "20",
                     "--out-dir", str(tmp_path)], tmp_path)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.count("==done==") == 1 and res.stdout.count("==timestep: 19==") == 1
    av = io.read_av_vels(tmp_path / io.AV_VELS_FILE)
    assert av.shape == (20,) and np.all(np.isfinite(av))
    ck = tmp_path / "ck"
    res = _torchrun([*MINI, "--device", "cpu", "--backend", "sharded", "--devices", "2",
                     "--checkpoint-every", "100", "--checkpoint-dir", str(ck),
                     "--out-dir", str(ck)], tmp_path)
    assert res.returncode != 0 and "==done==" not in res.stdout
    assert res.stderr.count("Error: checkpoint/resume runs in a single process") == 2
    assert not ck.exists()


def test_cli_multihost_in_one_process(tmp_path, capsys):
    """``--multihost`` with no launch in the environment forms a group of
    one process, runs, and takes the group down again."""
    rc = cli.main([*MINI, "--device", "cpu", "--iters", "20", "--multihost",
                   "--out-dir", str(tmp_path)])
    assert rc == 0 and capsys.readouterr().out.count("==done==") == 1
    assert multihost.process_count() == 1 and multihost.backend() is None
    assert (tmp_path / io.FINAL_STATE_FILE).exists()


def test_mesh_refuses_an_idle_process(monkeypatch):
    """A mesh that leaves a process of the group without a shard is
    refused before any run."""
    jp, mask, f0 = make_case(32, 32)
    monkeypatch.setattr(multihost, "process_count", lambda: 2)
    ring = mesh.Mesh((torch.device("cpu"),) * 2, (2, 1), torus=False, ranks=(0, 0))
    with pytest.raises(ValueError, match=r"leaves process\(es\) \[1\]"):
        halo.make_sharded_runner(ring, LBMParams.from_jax(jp), 2)
