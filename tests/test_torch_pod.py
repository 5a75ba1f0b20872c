"""is3d_tpu_torch's pod mode on the CPU: IS3D(mesh=) operation 2 over W = 2
and 3 gloo ranks, parallel.multihost's pod entries, and the CLI's pod keys.

One spawn of W ranks per W (testing.pod_suite_rank) runs:

* IS3D(mesh=) operation 2 under is3d_tpu's pod rule (rank r samples
  event_partition (r, W) through the one-device sampler): the OSCAR list
  without and with the event decays (event_offset, one shared decay seed)
  and the test_sampler histogram tree; rank 0's merged files are the
  one-process files BYTE FOR BYTE, no part file is left, and the ranks'
  event slices concatenate to the one-process list;
* the shared-filesystem probe: a results_dir that one rank cannot see
  makes every rank raise before the sampling;
* smooth_spectra_pod (df 2 and df 3), smooth_spectra_vah_pod,
  spin_polarization_pod and spacetime_distributions_pod on each run's
  full surface: every rank's array equals IS3D(mesh=)'s and one
  process's bit for bit.

The CLI: two ``python -m is3d_tpu_torch`` processes with the pod keys on
127.0.0.1 (mesh_backend=gloo), operation 1 and operation 2 with decays,
against one process's CLI: the results trees byte for byte; a missing pod
key returns 2.  f64, 48 cells on a narrow grid; one worker, about 40 s.
"""

import os
import shutil
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from is3d_tpu_torch import cli, testing
from is3d_tpu_torch.api import IS3D

from test_torch_slice import _tree

torch.set_num_threads(1)

W_ALL = (2, 3)
N_CELLS = 48
JOIN_TIMEOUT = 240.0
SAMPLE = dict(operation=2, oversample=1, min_num_hadrons=700,
              sampler_seed=17)
# name: (write_synthetic_run_dir arguments, overrides)
RUNS = {
    "op2": (dict(n_species=7, dimension=2, params=SAMPLE), {}),
    "op2_decays": (dict(n_species=24, dimension=2, decays=True,
                        params=SAMPLE), {}),
    "op2_test_sampler": (dict(n_species=7, dimension=2, params=SAMPLE),
                         dict(test_sampler=1)),
}
ENTRIES = {
    "op1_3d_df2": (dict(n_species=7, dimension=3), dict(df_mode=2)),
    "op1_2d_df3": (dict(n_species=7, dimension=2, scale_bulk=30.0),
                   dict(df_mode=3)),
    "op1_2d_vah": (dict(n_species=7, dimension=2, mode=2), {}),
    "op1_2d_mode5": (dict(n_species=7, dimension=2, mode=5),
                     dict(df_mode=2)),
    "op0_2d_df2": (dict(n_species=7, dimension=2), dict(operation=0)),
}


def _run_dir(root, name, kw):
    return testing.write_momentum_tables(testing.write_synthetic_run_dir(
        str(root / name), N_CELLS, seed=len(name), **kw))


def _one(run_dir, overrides, results):
    return IS3D.from_run_dir(run_dir, overrides=overrides, device="cpu",
                             results_dir=os.path.join(run_dir, results)
                             ).run_particlization()


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    root = tmp_path_factory.mktemp("pod")
    runs, entries, one = [], [], {}
    for table, out in ((RUNS, runs), (ENTRIES, entries)):
        for name, (kw, overrides) in table.items():
            run_dir = _run_dir(root, name, kw)
            out.append(dict(name=name, run_dir=run_dir, overrides=overrides,
                            shared=table is RUNS))
            one[name] = _one(run_dir, overrides, "one")
    return dict(root=root, runs=runs, entries=entries, one=one)


@pytest.fixture(scope="module")
def spawned(inputs):
    done = {}

    def spawn(W):
        if W not in done:
            runs = [dict(r, results_dir=os.path.join(r["run_dir"],
                                                     f"mesh{W}"))
                    for r in inputs["runs"] + inputs["entries"]]
            probe = dict(inputs["runs"][0], results_dir=str(
                inputs["root"] / f"probe{W}"))
            done[W] = testing.run_ranks(
                testing.pod_suite_rank, W, str(inputs["root"] / f"w{W}"),
                args=(runs, inputs["entries"], probe),
                timeout=JOIN_TIMEOUT)
        return done[W]
    return spawn


@pytest.fixture(scope="module", params=W_ALL)
def ranks(request, spawned):
    return request.param, spawned(request.param)


def _same_tree(a, b):
    ta, tb = _tree(a), _tree(b)
    assert sorted(ta) == sorted(tb) and ta
    for rel in ta:
        with open(ta[rel], "rb") as fa, open(tb[rel], "rb") as fb:
            assert fa.read() == fb.read(), rel
    return ta


@pytest.mark.parametrize("name", sorted(RUNS))
def test_operation2_over_ranks_matches_one_process_bytes(ranks, inputs,
                                                         name):
    W, out = ranks
    run = next(r for r in inputs["runs"] if r["name"] == name)
    want = inputs["one"][name].events
    got = [res["api"][name]["events"] for res in out]
    n = len(want)
    assert n >= W and [len(g) for g in got] == [
        (r + 1) * n // W - r * n // W for r in range(W)]
    assert testing.same_events([e for g in got for e in g], want)
    tree = _same_tree(os.path.join(run["run_dir"], "one"),
                      os.path.join(run["run_dir"], f"mesh{W}"))
    if name == "op2_test_sampler":
        assert len(tree) > 3 and "particle_list_osc.dat" not in tree
    else:
        assert list(tree) == ["particle_list_osc.dat"]


def test_decays_over_ranks_decay_the_global_events(inputs):
    """The decayed list is not the undecayed one: the decays ran, on
    every rank's slice with its global event offset (the bytes above)."""
    a = inputs["one"]["op2_decays"].events
    assert sum(len(e["mcid"]) for e in a) > 0
    run = next(r for r in inputs["runs"] if r["name"] == "op2_decays")
    undecayed = _one(run["run_dir"], dict(do_resonance_decays=0),
                     "undecayed").events
    assert sum(len(e["mcid"]) for e in a) > sum(len(e["mcid"])
                                                 for e in undecayed)


def test_shared_fs_probe_raises_on_every_rank(ranks, inputs):
    W, out = ranks
    for res in out:
        assert res["probe"] is not None
        assert f"not visible to rank(s) {list(range(1, W))}" in res["probe"]
    assert not os.path.exists(inputs["root"] / f"probe{W}_0" /
                              "particle_list_osc.dat")


def test_pod_active_on_every_rank(ranks):
    from is3d_tpu_torch.parallel.multihost import pod_active
    W, out = ranks
    assert [res["pod_active"] for res in out] == [True] * W
    assert not pod_active()          # this process joined no group


@pytest.mark.parametrize("name", sorted(ENTRIES))
def test_pod_entries_match_mesh_and_one_process(ranks, inputs, name):
    W, out = ranks
    one = inputs["one"][name]
    for r, res in enumerate(out):
        got, api = res["entries"][name], res["api"][name]
        assert got
        for key, value in got.items():
            want = getattr(one, key)
            if isinstance(want, dict):
                assert set(value) == set(want)
                for k in want:
                    assert np.array_equal(value[k], want[k],
                                          equal_nan=True), (W, r, key, k)
                    assert np.array_equal(value[k], api[key][k],
                                          equal_nan=True), (W, r, key, k)
            else:
                assert np.array_equal(value, want), (W, r, key)
                assert np.array_equal(value, api[key]), (W, r, key)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _cli(args, env):
    return subprocess.Popen([sys.executable, "-m", "is3d_tpu_torch", *args],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


@pytest.mark.parametrize("name,args", [
    ("op1_3d_df2", ["df_mode=2"]),
    ("op2_decays", []),
])
def test_cli_pod_keys_match_one_process_cli(inputs, tmp_path, name, args):
    """Two CLI ranks on 127.0.0.1 (gloo) against one CLI process, all of
    one torch thread: rank 0's results tree byte for byte."""
    src = next(r for r in inputs["runs"] + inputs["entries"]
               if r["name"] == name)["run_dir"]
    one, pod = (shutil.copytree(src, tmp_path / d) for d in ("one", "pod"))
    root = os.path.dirname(os.path.dirname(os.path.abspath(cli.__file__)))
    env = dict(os.environ, OMP_NUM_THREADS="1", GLOO_SOCKET_IFNAME="lo",
               PYTHONPATH=os.pathsep.join(
                   [root] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    port = _free_port()
    procs = [_cli([str(one), "device=cpu", *args], env)] + [
        _cli([str(pod), "device=cpu", *args, "mesh_backend=gloo",
              f"multihost_coordinator=127.0.0.1:{port}", "multihost_nproc=2",
              f"multihost_pid={i}"], env) for i in range(2)]
    try:
        logs = [p.communicate(timeout=180)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0, 0], logs
    assert "mesh = rank 1 of 2 (gloo)" in logs[2]
    _same_tree(one / "results", pod / "results")


def test_cli_missing_pod_key_returns_2(inputs, capsys):
    run_dir = inputs["entries"][0]["run_dir"]
    assert cli.main([run_dir, "device=cpu",
                     "multihost_coordinator=127.0.0.1:1",
                     "multihost_nproc=2"]) == 2
    assert "missing multihost_pid" in capsys.readouterr().err
    assert cli.main([run_dir, "device=cpu", "mesh_backend=gloo"]) == 2
