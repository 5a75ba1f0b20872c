"""The plain versions of the experiments' kernels against the JAX
experiments themselves: the spectra prototype against P1's Pallas kernel
(experiments/pallas_smooth_proto.py) run in interpret mode, and the
reduction probe against P2's XLA reference v_einsum_m
(experiments/probe_dndx_reduce.py).  experiments/ is no package, so both
are imported by path."""

import importlib.util
import os

import numpy as np
import jax.numpy as jnp
import torch

from is3d_tpu_torch.experiments import smooth_proto, dndx_reduce_probe

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name):
    path = os.path.join(ROOT, "experiments", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"_exp_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_proto_plain_matches_pallas_interpret(monkeypatch):
    """f32 on both sides at P1's shape with C = 32 cells (what its own
    verify() does): the tolerance of the kernel checks (rtol 2e-4, atol
    2e-5 x max), for f32 sums in different orders."""
    monkeypatch.setenv("PALLAS_INTERPRET", "1")
    p1 = _load("pallas_smooth_proto")
    monkeypatch.setattr(p1, "C", 32)
    x = smooth_proto.proto_inputs(32, S=p1.S, P=p1.P, F=p1.F, Y=p1.Y,
                                  seed=1)
    assert smooth_proto.FIELDS == p1.FIELDS
    args = [x[n] for n in smooth_proto.ARGS]
    want = np.asarray(p1.pallas_spectra(*(jnp.asarray(a.numpy())
                                          for a in args)))
    got = smooth_proto.proto_spectra_plain(*args).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.isfinite(want).all() and np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=2e-4,
                               atol=2e-5 * np.abs(want).max())


def test_proto_plain_matches_pallas_interpret_with_masked_cells(monkeypatch):
    """As above with mask 0 on every third cell: the masked rows add
    exactly 0 on both sides, so both equal their sums without those rows
    (the plain version at 1e-6 of max: another f32 summation order)."""
    monkeypatch.setenv("PALLAS_INTERPRET", "1")
    p1 = _load("pallas_smooth_proto")
    monkeypatch.setattr(p1, "C", 32)
    x = smooth_proto.proto_inputs(32, S=p1.S, P=p1.P, F=p1.F, Y=p1.Y,
                                  seed=4)
    x["cells"][::3, smooth_proto.IDX["mask"]] = 0.0
    args = [x[n] for n in smooth_proto.ARGS]
    want = np.asarray(p1.pallas_spectra(*(jnp.asarray(a.numpy())
                                          for a in args)))
    got = smooth_proto.proto_spectra_plain(*args).numpy()
    assert np.isfinite(want).all() and np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=2e-4,
                               atol=2e-5 * np.abs(want).max())
    kept = x["cells"][x["cells"][:, smooth_proto.IDX["mask"]] > 0]
    assert kept.shape[0] == 21
    dense = smooth_proto.proto_spectra_plain(kept.contiguous(),
                                             *args[1:]).numpy()
    np.testing.assert_allclose(got, dense, rtol=0,
                               atol=1e-6 * np.abs(dense).max())
    x["cells"][:, smooth_proto.IDX["mask"]] = 0.0
    none = smooth_proto.proto_spectra_plain(x["cells"], *args[1:])
    assert torch.equal(none, torch.zeros_like(none))


def test_proto_plain_is_chunk_invariant():
    """The cell chunking of the plain version only regroups the sum."""
    x = smooth_proto.proto_inputs(9, S=64, P=3, F=4, Y=3, seed=2,
                                  dtype=torch.float64)
    args = [x[n] for n in smooth_proto.ARGS]
    whole = smooth_proto.proto_spectra_plain(*args)
    chunked = smooth_proto.proto_spectra_plain(*args, cell_chunk=2)
    assert whole.shape == (2, 3, 32, 12)
    torch.testing.assert_close(chunked, whole, rtol=1e-13, atol=0)


def test_probe_plain_matches_v_einsum_m():
    """f64 on both sides, small shapes, chunked over cells: rtol 1e-12."""
    p2 = _load("probe_dndx_reduce")
    x = dndx_reduce_probe.probe_inputs(11, 5, 7, 13, seed=3,
                                       dtype=torch.float64)
    a, b, w, wM, wR = (x[k] for k in ("a", "b", "w", "wM", "wR"))
    want = p2.v_einsum_m(jnp.asarray(a.numpy())[:, :, None, None],
                         jnp.asarray(b.numpy())[None, None],
                         jnp.asarray(w.numpy())[None, None],
                         jnp.asarray(wM.numpy()), jnp.asarray(wR.numpy()))
    got = dndx_reduce_probe.percell_probe_plain(a, b, w, wM, wR,
                                                cell_chunk=4)
    for g, w_, shape in zip(got, want, ((11, 7), (7, 5))):
        w_ = np.asarray(w_)
        assert g.shape == shape == w_.shape
        np.testing.assert_allclose(g.numpy(), w_, rtol=1e-12)
