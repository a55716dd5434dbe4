"""The port's engine on graphs against the JAX engine: a 3-way tensor, two
relations sharing an entity with sampled alpha, a symmetric relation with a
degree-zero row, an entity outside every relation, "planned" accumulation
beside dense relations, a fused relation sharing an entity with a float
pair, and an int8 multi-relation graph at K = 36, each on the paths it
takes (gather, float pair, int8 pair), in float64 with the same injected
randoms; and, op by op, the arity-3 int8 contribution, the alpha draw, the
random spec and the graph-building API.

The JAX engine runs with ``pallas="off"`` (its XLA samplers, no
interpret mode); the port samples with its kernels' plain versions."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bayesiandatafusion_jl_tpu as bdf
from bayesiandatafusion_jl_tpu.models.engine import MacauEngine
from bayesiandatafusion_jl_tpu.ops import dense_gram as jdg
from bayesiandatafusion_jl_tpu.ops.hyper import sample_alpha as jax_alpha
from bayesiandatafusion_jl_tpu.utils.config import MacauConfig
from bayesiandatafusion_jl_tpu.utils.rng import draw_all_numpy
import bayesiandatafusion_jl_tpu_torch as bt
from bayesiandatafusion_jl_tpu_torch.models import engine as torch_engine_mod
from bayesiandatafusion_jl_tpu_torch.ops import dense_gram as tdg
from bayesiandatafusion_jl_tpu_torch.ops import pair_contract as tpc
from bayesiandatafusion_jl_tpu_torch.ops.hyper import sample_alpha
from bayesiandatafusion_jl_tpu_torch.utils import rng as trng
from bayesiandatafusion_jl_tpu_torch.utils.convert import (state_from_numpy,
                                                           state_to_numpy)
from _torch_xla_order import xla_cpu_ridge_step


@pytest.fixture
def xla_cpu_ridge(monkeypatch):
    """The port's ridge step summed in the JAX engine's (XLA:CPU) order."""
    monkeypatch.setattr(tdg, "ridge_step", xla_cpu_ridge_step)


# -- graphs: each function takes the package (bdf or bt) and returns its
# RelationData, the same numbers for both -------------------------------

def tensor_graph(pkg):
    """tests/test_oracle_equiv.py:128: a (9, 8, 5) tensor, 40% observed."""
    rng = np.random.default_rng(3)
    shape = (9, 8, 5)
    T = rng.standard_normal(shape)
    mask = rng.random(shape) < 0.4
    idx = np.stack(np.nonzero(mask), 1)
    rd = pkg.RelationData.from_indexed_df(pkg.IndexedDF(idx, T[mask], shape))
    rd.assign_to_test(0, 12, seed=7)
    return rd


def two_relation_graph(pkg):
    """tests/test_oracle_equiv.py:149/:215: r1 (c x t) and r2 (c x a)
    share c; both alphas sampled."""
    rng = np.random.default_rng(5)
    nc, nt, na = 15, 12, 7
    e_c, e_t, e_a = (pkg.Entity(n, count=c)
                     for n, c in [("c", nc), ("t", nt), ("a", na)])
    rd = pkg.RelationData()
    for name, ents, shp in [("r1", [e_c, e_t], (nc, nt)),
                            ("r2", [e_c, e_a], (nc, na))]:
        R = rng.standard_normal(shp)
        mask = rng.random(shp) < 0.5
        rd.add_relation(
            pkg.IndexedDF(np.stack(np.nonzero(mask), 1), R[mask], shp),
            name, ents)
    rd.set_precision("r1", 5.0, sample=True)
    rd.set_precision("r2", 2.0, sample=True)
    rd.assign_to_test("r2", 10, seed=3)
    return rd


def symmetric_graph(pkg):
    """tests/test_oracle_equiv.py:168/:237: one entity on both modes of a
    relation, row and column 4 empty."""
    rng = np.random.default_rng(34)
    n = 18
    mask = rng.random((n, n)) < 0.4
    np.fill_diagonal(mask, False)
    mask[4, :] = False
    mask[:, 4] = False
    idx = np.stack(np.nonzero(mask), 1)
    e = pkg.Entity("drug", count=n)
    rd = pkg.RelationData()
    rd.add_relation(pkg.IndexedDF(idx, rng.standard_normal(idx.shape[0]),
                                  (n, n)), "interaction", [e, e])
    return rd


def lonely_entity_graph(pkg):
    """A ratings matrix and an entity in no relation: its rows draw from
    the prior every sweep."""
    rng = np.random.default_rng(8)
    R = rng.standard_normal((14, 11))
    mask = rng.random((14, 11)) < 0.5
    rd = pkg.RelationData.from_indexed_df(
        pkg.IndexedDF(np.stack(np.nonzero(mask), 1), R[mask], (14, 11)))
    rd.entities.append(pkg.Entity("alone", count=6))
    rd.assign_to_test(0, 8, seed=2)
    return rd


def fused_and_float_graph(pkg):
    """A half-star ratings relation with cells rated twice (the fused
    path's duplicates residual) and a real-valued relation (no grid: the
    float pair) on a shared user entity."""
    rng = np.random.default_rng(11)
    nu, nm, nf = 20, 16, 9
    e_u, e_m, e_f = (pkg.Entity(n, count=c)
                     for n, c in [("user", nu), ("movie", nm), ("feat", nf)])
    mask = rng.random((nu, nm)) < 0.5
    idx = np.stack(np.nonzero(mask), 1)
    vals = np.clip(np.round((3 + rng.standard_normal(len(idx))) * 2) / 2,
                   1, 5)
    idx = np.concatenate([idx, idx[:5]])
    vals = np.concatenate([vals, rng.integers(2, 11, 5) * 0.5])
    rd = pkg.RelationData()
    rd.add_relation(pkg.IndexedDF(idx, vals, (nu, nm)), "ratings",
                    [e_u, e_m])
    mask = rng.random((nu, nf)) < 0.6
    rd.add_relation(pkg.IndexedDF(np.stack(np.nonzero(mask), 1),
                                  rng.standard_normal(int(mask.sum())),
                                  (nu, nf)), "side", [e_u, e_f])
    rd.assign_to_test("ratings", 15, seed=1)
    return rd


GRAPHS = {"tensor": tensor_graph, "two_relations": two_relation_graph,
          "symmetric": symmetric_graph, "lonely": lonely_entity_graph,
          "fused_float": fused_and_float_graph}
PATHS = {"gather": dict(dense_gram=False),
         "float": dict(dense_gram=True, dense_int8=False),
         "int8": dict(dense_gram=True, dense_int8=True)}


def _engines(graph, K, **opts):
    """The JAX engine (``pallas="off"``) and the port's on the CPU, both in
    float64 on the same graph."""
    common = dict(num_latent=K, dtype="float64", seed=5, verbose=False,
                  **opts)
    ej = MacauEngine(GRAPHS[graph](bdf), MacauConfig(pallas="off", **common))
    et = bt.MacauEngine(GRAPHS[graph](bt), bt.MacauConfig(**common),
                        device="cpu")
    return ej, et


def _run_both(ej, et, n_sweeps=3):
    """``n_sweeps`` sweeps of both engines on the same randoms: U, mu and
    Lambda of every entity, every sampled alpha and every relation's sample
    RMSE and prediction sums agree to 1e-8 after each."""
    state_j = ej.init_state(jax.random.fold_in(jax.random.key(5), 0))
    state_t = state_from_numpy(jax.device_get(state_j), "cpu",
                               torch.float64)
    spec = ej.problem.random_spec
    assert et.problem.random_spec == {
        k: trng.DrawSpec(v.kind, v.shape, v.gamma_a)
        for k, v in spec.items()}
    rng = np.random.default_rng(999)
    for s in range(n_sweeps):
        randoms = draw_all_numpy(rng, spec)
        acc = 1.0 if s >= 1 else 0.0
        state_j, mj = ej._sweep_randoms_jit(
            ej.problem.arrays, state_j,
            {k: jnp.asarray(v) for k, v in randoms.items()}, acc)
        state_t, mt = et._sweep_with_randoms(
            state_t, {k: torch.from_numpy(v) for k, v in randoms.items()},
            acc)
        sj, st = jax.device_get(state_j), state_to_numpy(state_t)
        for ei in range(len(ej.problem.entity_specs)):
            for key in ("U", "mu", "Lambda"):
                np.testing.assert_allclose(
                    st["ent"][ei][key], sj["ent"][ei][key], rtol=1e-8,
                    atol=1e-8, err_msg=f"{key} sweep {s} entity {ei}")
        for ri in range(len(ej.problem.rel_specs)):
            np.testing.assert_allclose(
                st["rel"][ri]["alpha"], sj["rel"][ri]["alpha"], rtol=1e-8,
                err_msg=f"alpha sweep {s} relation {ri}")
        assert set(mt) == set(mj)
        for k in mj:
            np.testing.assert_allclose(float(mt[k]), float(mj[k]),
                                       rtol=1e-8, atol=1e-8, err_msg=k)
        for key in sj["pred"]:
            np.testing.assert_allclose(st["pred"][key]["sum"],
                                       sj["pred"][key]["sum"], rtol=1e-8,
                                       atol=1e-8)
    return state_t


@pytest.fixture
def branches(monkeypatch):
    """The port's sampler branch per entity draw: "packed" or "full"."""
    seen = []
    for name, tag in (("chol_sample_packed_dispatch", "packed"),
                      ("chol_sample_dispatch", "full")):
        fn = getattr(torch_engine_mod, name)

        def wrapped(*a, _fn=fn, _tag=tag, **kw):
            seen.append(_tag)
            return _fn(*a, **kw)
        monkeypatch.setattr(torch_engine_mod, name, wrapped)
    return seen


@pytest.mark.parametrize("path", ["gather", "float", "int8"])
def test_tensor_matches_jax_engine(xla_cpu_ridge, branches, path):
    """The (9, 8, 5) tensor, K = 4: on the gather path (arity-3 buckets, the
    full-P sampler), and on the dense float and int8 pairs, every focus
    axis of the store (mode 0, the largest, contracts mode 1 on the
    trailing store axis; modes 1 and 2 contract mode 0 on the leading
    one), P packed.  3 float64 sweeps to 1e-8."""
    ej, et = _engines("tensor", 4, **PATHS[path])
    prob = et.problem
    assert prob.kinds == ["pair" if path != "gather" else "gather"]
    assert prob.pair_i8s[0] == (path == "int8")
    if path != "gather":
        assert prob.stores[0]["order"] == (0, 2, 1)
    _run_both(ej, et)
    assert branches == ["full" if path == "gather" else "packed"] * 9


@pytest.mark.parametrize("path", ["gather", "float", "int8"])
def test_two_relations_alpha_matches_jax_engine(xla_cpu_ridge, branches,
                                                path):
    """Two relations sharing entity c, both alphas sampled from the
    training residuals after every sweep (``r{ri}.alpha``); c sums two
    contributions.  3 float64 sweeps to 1e-8, alphas included."""
    ej, et = _engines("two_relations", 3, **PATHS[path])
    assert [rs.alpha_sample for rs in et.problem.rel_specs] == [True, True]
    assert "r1.alpha_g" in et.problem.random_spec
    st = _run_both(ej, et)
    assert len(branches) == 9
    assert float(st["rel"][0]["alpha"]) != 5.0


@pytest.mark.parametrize("path", ["gather", "float", "int8"])
def test_symmetric_relation_matches_jax_engine(xla_cpu_ridge, path):
    """One entity on both modes of a relation, with a degree-zero row and
    column: two contributions, each with the entity's own current U as
    partner; the empty row draws from the prior.  3 float64 sweeps."""
    ej, et = _engines("symmetric", 3, **PATHS[path])
    _run_both(ej, et)


@pytest.mark.parametrize("path", ["gather", "int8"])
def test_lonely_entity_matches_jax_engine(xla_cpu_ridge, branches, path):
    """An entity outside every relation draws its rows from its prior
    (the full-P branch with no contribution).  3 float64 sweeps."""
    ej, et = _engines("lonely", 3, **PATHS[path])
    _run_both(ej, et)
    assert branches[2::3] == ["full"] * 3


@pytest.mark.parametrize("graph, path", [("two_relations", "float"),
                                         ("two_relations", "int8"),
                                         ("fused_float", "float")])
def test_planned_beside_dense_matches_jax_engine(xla_cpu_ridge, branches,
                                                 graph, path):
    """"planned" accumulation with dense relations: P is full, the gather
    buckets (here the fused relation's duplicates residual) through the
    static plan with Lambda in P, the dense contributions unpacked and
    added.  3 float64 sweeps to 1e-8."""
    opts = dict(PATHS[path], accumulation="planned")
    if graph == "fused_float":
        opts["dense_fused"] = True
    ej, et = _engines(graph, 3, **opts)
    if graph == "fused_float":
        assert et.problem.kinds == ["fused", "pair"]
        assert et.problem.residual_nnzs == [5, 0]
    _run_both(ej, et)
    assert set(branches) == {"full"}


@pytest.mark.parametrize("K", [4, 36])
def test_fused_beside_float_pair_matches_jax_engine(branches, K):
    """A fused relation (half-star grid, dense_fused=True, float kernels
    under dense_int8=False) with its duplicates residual, sharing the user
    entity with a float pair: the user sums the fused contribution, the
    residual's buckets and the float pair's, P packed (K1 at K = 4, K2 at
    K = 36).  3 float64 sweeps to 1e-8."""
    ej, et = _engines("fused_float", K, dense_gram=True, dense_int8=False,
                      dense_fused=True)
    assert et.problem.kinds == ["fused", "pair"]
    assert ej.problem.fused_rels.keys() == {0}
    assert not et.problem.fused_i8s[0] and not et.problem.pair_i8s[1]
    _run_both(ej, et)
    assert set(branches) == {"packed"}


def test_int8_two_relations_k36_matches_jax_engine(xla_cpu_ridge, branches):
    """The int8 pairs of two relations at K = 36: the shared entity's two
    s8 contributions summed in the packed layout and sampled by K2's
    plain version.  3 float64 sweeps to 1e-8, alphas included."""
    ej, et = _engines("two_relations", 36, **PATHS["int8"])
    assert et.problem.pair_i8s == [True, True]
    _run_both(ej, et)
    assert branches == ["packed"] * 9


# -- op level ------------------------------------------------------------

def _tensor_data(shape, seed, density=0.4):
    rng = np.random.default_rng(seed)
    mask = rng.random(shape) < density
    idx = np.stack(np.nonzero(mask), 1)
    vals = rng.standard_normal(len(idx))
    return idx, vals - vals.mean(), rng


@pytest.mark.parametrize("shape", [(9, 8, 5), (6, 20, 11), (7, 7, 30)])
@pytest.mark.parametrize("layout", ["packed", "unpacked"])
def test_int8_tensor_contrib_matches_jax(shape, layout):
    """The arity-3 int8 contribution of each focus mode against the JAX s8
    branch of ``dense_gram_contrib`` (float64, alpha 2.5, the ridge):

    - the store equals JAX's quantized pair permuted to ``store_order``,
      and the same ``w_scale``;
    - step 1's int32 sums (K6's plain version on the 2-D view) equal the
      exact int64 contraction of JAX's codes with JAX's quantized table,
      bit for bit;
    - b and P off the diagonal to 1e-12 of the largest entry, the
      diagonal (with the ridge) to 1e-6, in the transposed packed layout
      (JAX ``transposed=True``) or unpacked."""
    K = 5
    idx, cen, rng = _tensor_data(shape, sum(shape))
    M, W = jdg.build_dense_pair(idx, cen.copy(), shape, np.float64)
    M8, W8, w_scale = jdg.quantize_dense_pair(M, W)
    pair = tdg.build_int8_pair(idx, cen, shape, np.float64, "cpu")
    order = pair["order"]
    assert pair["w_scale"] == w_scale
    want8 = np.transpose(M8.reshape(shape), order)
    got8 = pair["M8"].numpy()[tuple(slice(0, n) for n in want8.shape)]
    np.testing.assert_array_equal(got8, want8)
    assert not pair["M8"].numpy().sum() - got8.sum()
    np.testing.assert_array_equal(
        pair["W8"].numpy()[tuple(slice(0, n) for n in want8.shape)],
        np.transpose(W8.reshape(shape), order))
    Us = [rng.standard_normal((n, K)) for n in shape]
    tri = tdg.tri_index(K, "cpu")
    iu, ju, _ = jdg._tri_maps(K)
    for mode in range(3):
        parts = [d for d in range(3) if d != mode]
        big = tdg.big_partner(shape, mode)
        assert big == order[-1] if mode == order[0] else big == order[0]
        # step 1's exact sums against JAX's codes and quantized table
        Uf = np.asarray(Us[big], np.float32)
        Y8, _ = jdg._quantize_cols(jnp.asarray(Uf[:, iu] * Uf[:, ju]))
        letters = "abc"
        rem = "".join(letters[d] for d in range(3) if d != big)
        want = np.einsum(f"abc,{letters[big]}z->{rem}z",
                         M8.reshape(shape).astype(np.int64),
                         np.asarray(Y8, np.int64))
        M2, k6_mode, _ = tdg._step1_view(pair["M8"], order, big)
        YZ8T = tdg.fused_quantize(torch.from_numpy(Us[big]),
                                  pad_rows=M2.shape[1 - k6_mode], tri=tri)[0]
        PM, _ = tpc.pair_contract_plain(M2, pair["W8"].view(M2.shape), YZ8T,
                                        k6_mode, K, M2.shape[k6_mode])
        got = PM.numpy().reshape(
            (-1,) + tuple(pair["M8"].shape[ax] for ax in
                          ((0, 1) if k6_mode == 0 else (1, 2))))
        # the store axes of the sums, in mode order, cut to the true extents
        modes = [order[ax] for ax in ((0, 1) if k6_mode == 0 else (1, 2))]
        got = got[(slice(None),) + tuple(slice(0, shape[d]) for d in modes)]
        perm = [1 + modes.index(d) for d in range(3) if d != big] + [0]
        np.testing.assert_array_equal(np.transpose(got, perm), want)
        # the whole contribution
        packed = layout == "packed"
        Pj, bj = jdg.dense_gram_contrib(
            jnp.asarray(M8), jnp.asarray(W8),
            [jnp.asarray(Us[d]) for d in parts], mode, shape, jnp.float64,
            jnp.float64, packed=packed, transposed=packed, w_scale=w_scale,
            ridge_deg=jnp.asarray(np.bincount(idx[:, mode],
                                              minlength=shape[mode]),
                                  jnp.float32),
            alpha=jnp.asarray(2.5))
        Pt, b = tdg.int8_pair_contrib(
            pair, tri, [torch.from_numpy(Us[d]) for d in parts], mode,
            torch.tensor(2.5, dtype=torch.float64), torch.float64,
            packed=packed)
        Pj, bj = np.asarray(Pj), np.asarray(bj)
        assert Pt.shape == Pj.shape and b.shape == bj.shape
        np.testing.assert_allclose(b.numpy(), bj, rtol=0,
                                   atol=1e-12 * np.abs(bj).max())
        # the PD ridge on the diagonal is a float32 step, mean(sY) sqrt(K)
        # / 2, whose sum XLA rounds in its own order outside the engine's
        # compiled sweep: the diagonal to float32 precision, the rest to
        # float64 rounding
        diag = np.zeros(Pj.shape, bool)
        if packed:
            diag[iu == ju] = True
        else:
            diag[:, np.arange(K), np.arange(K)] = True
        np.testing.assert_allclose(Pt.numpy()[~diag], Pj[~diag], rtol=0,
                                   atol=1e-12 * np.abs(Pj).max())
        np.testing.assert_allclose(Pt.numpy()[diag], Pj[diag], rtol=1e-6)


def test_float_tensor_contrib_matches_jax():
    """The arity-3 float pair's contribution of each focus mode against the
    JAX float branch (float64, alpha 1.5), packed transposed and unpacked,
    to 1e-12 of the largest entry."""
    shape, K = (9, 8, 5), 4
    idx, cen, rng = _tensor_data(shape, 21)
    M, W = jdg.build_dense_pair(idx, cen.copy(), shape, np.float64)
    pair = tdg.build_dense_pair(idx, cen, shape, torch.float64, "cpu")
    Us = [rng.standard_normal((n, K)) for n in shape]
    tri = tdg.tri_index(K, "cpu")
    for mode in range(3):
        parts = [d for d in range(3) if d != mode]
        for packed in (True, False):
            Pj, bj = jdg.dense_gram_contrib(
                jnp.asarray(M), jnp.asarray(W),
                [jnp.asarray(Us[d]) for d in parts], mode, shape,
                jnp.float64, jnp.float64, packed=packed, transposed=packed,
                alpha=jnp.asarray(1.5))
            Pt, b = tdg.float_pair_contrib(
                pair, tri, [torch.from_numpy(Us[d]) for d in parts], mode,
                torch.tensor(1.5, dtype=torch.float64), torch.float64,
                packed=packed)
            for g, w in ((Pt, Pj), (b, bj)):
                w = np.asarray(w)
                np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                           atol=1e-12 * np.abs(w).max())


@pytest.mark.parametrize("path", ["gather", "float", "int8"])
def test_int8_arity4_raises(xla_cpu_ridge, path):
    """The (4, 5, 3, 6) tensor, K = 3, on the int8 pair (ROADMAP M12: it
    raised before; one store [6, 4, 3, 5] for the four modes, each first
    step on the store read as a matrix, the two other partners in one
    einsum), the float pair and the gather path, against the JAX engine:
    3 float64 sweeps to 1e-8."""
    shape = (4, 5, 3, 6)
    idx, cen, _ = _tensor_data(shape, 2)

    def graph(pkg):
        rd = pkg.RelationData.from_indexed_df(pkg.IndexedDF(idx, cen, shape))
        rd.assign_to_test(0, 10, seed=7)
        return rd
    GRAPHS["arity4"] = graph
    try:
        ej, et = _engines("arity4", 3, **PATHS[path])
    finally:
        del GRAPHS["arity4"]
    assert et.problem.pair_i8s == [path == "int8"]
    if path != "gather":
        assert et.problem.stores[0]["order"] == (3, 0, 2, 1)
    _run_both(ej, et)


def test_sample_alpha_matches_jax():
    for sse, n, g in ((12.5, 40, 17.3), (0.3, 7, 2.2)):
        want = float(jax_alpha(jnp.asarray(sse), n, jnp.asarray(g), 1e-3,
                               2e-3))
        got = float(sample_alpha(torch.tensor(sse, dtype=torch.float64), n,
                                 torch.tensor(g, dtype=torch.float64), 1e-3,
                                 2e-3))
        assert got == pytest.approx(want, rel=1e-15)


def test_random_spec_matches_jax():
    """Keys, shapes and Gamma parameters of the sweep's draws equal the JAX
    engine's on a graph with one sampled and one fixed alpha, and the
    config's alpha_a0 enters the Gamma shape."""
    def graph(pkg):
        rd = two_relation_graph(pkg)
        rd.set_precision("r2", 2.0, sample=False)
        return rd
    GRAPHS["partly_sampled"] = graph
    try:
        ej, et = _engines("partly_sampled", 3, alpha_a0=0.25)
    finally:
        del GRAPHS["partly_sampled"]
    spec_t = et.problem.random_spec
    assert spec_t == {k: trng.DrawSpec(v.kind, v.shape, v.gamma_a)
                      for k, v in ej.problem.random_spec.items()}
    assert "r0.alpha_g" in spec_t and "r1.alpha_g" not in spec_t
    nnz = et.problem.rel_specs[0].nnz
    assert spec_t["r0.alpha_g"].gamma_a == (0.25 + nnz / 2.0,)


def test_graph_building_matches_jax():
    """add_relation, from_matrix (IndexedDF, dense array, scipy matrix,
    side features) and IndexedDF's degrees, index, from_dense and
    from_scipy give what the JAX package's give."""
    import scipy.sparse as sp
    rj, rt = two_relation_graph(bdf), two_relation_graph(bt)
    assert ([(e.name, e.count) for e in rt.entities]
            == [(e.name, e.count) for e in rj.entities])
    for a, b in zip(rt.relations, rj.relations):
        assert a.name == b.name and a.data.shape == b.data.shape
        assert [rt.entities.index(e) for e in a.entities] == \
            [rj.entities.index(e) for e in b.entities]
        np.testing.assert_array_equal(a.data.idx, b.data.idx)
        np.testing.assert_array_equal(a.test_idx, b.test_idx)
    rng = np.random.default_rng(4)
    m = rng.standard_normal((6, 9)) * (rng.random((6, 9)) < 0.4)
    for src in (m, sp.csr_matrix(m), bt.IndexedDF.from_dense(m)):
        jsrc = (bdf.IndexedDF.from_dense(m)
                if isinstance(src, bt.IndexedDF) else src)
        a = bt.RelationData.from_matrix(src, names=("u", "v"))
        b = bdf.RelationData.from_matrix(jsrc, names=("u", "v"))
        assert [(e.name, e.count) for e in a.entities] == \
            [(e.name, e.count) for e in b.entities]
        np.testing.assert_array_equal(a.relations[0].data.idx,
                                      b.relations[0].data.idx)
        np.testing.assert_array_equal(a.relations[0].data.vals,
                                      b.relations[0].data.vals)
    df_t = bt.IndexedDF.from_scipy(sp.coo_matrix(m))
    df_j = bdf.IndexedDF.from_scipy(sp.coo_matrix(m))
    for mode in range(2):
        np.testing.assert_array_equal(df_t.degrees(mode), df_j.degrees(mode))
        for x, y in zip(df_t.index(mode), df_j.index(mode)):
            np.testing.assert_array_equal(x, y)
    # side features through from_matrix: the same feature matrices
    feats = (np.eye(6), rng.standard_normal((9, 4)))
    a = bt.RelationData.from_matrix(m, *feats)
    b = bdf.RelationData.from_matrix(m, *feats)
    for ea, eb in zip(a.entities, b.entities):
        assert ea.num_features == eb.num_features and ea.count == eb.count
        np.testing.assert_array_equal(ea.F.to_dense(), eb.F.to_dense())
        assert ea.F.is_binary == eb.F.is_binary


# -- the bench's graph generators, replayed as bench.py writes them (one
# pass, np.unique) at a small size ------------------------------------------

def _bench_tensor(shape, nnz, r, seed):
    """bench.py:200-211 (``bench_tensor``)."""
    n1, n2, n3 = shape
    rng = np.random.default_rng(seed)
    key = np.unique(rng.integers(0, n1 * n2 * n3, int(nnz * 1.15)))[:nnz]
    i1, i2, i3 = key // (n2 * n3), (key // n3) % n2, key % n3
    Us = [rng.standard_normal((n, r)) / np.sqrt(r) for n in (n1, n2, n3)]
    vals = (np.sum(Us[0][i1] * Us[1][i2] * Us[2][i3], axis=1) * np.sqrt(r)
            + 0.4 * rng.standard_normal(nnz))
    return [(np.stack([i1, i2, i3], 1), vals)]


def _bench_tensor_big(shape, nnz, r, seed):
    """bench.py:244-262 (``bench_tensor_big``)."""
    n1, n2, n3 = shape
    rng = np.random.default_rng(seed)
    key = np.unique(rng.integers(0, n1 * n2 * n3, int(nnz * 1.05),
                                 dtype=np.int64))[:nnz]
    i1 = (key // (n2 * n3)).astype(np.int32)
    i2 = ((key // n3) % n2).astype(np.int32)
    i3 = (key % n3).astype(np.int32)
    Us = [rng.standard_normal((n, r)).astype(np.float32) / np.sqrt(r)
          for n in (n1, n2, n3)]
    vals = (np.einsum("nk,nk,nk->n", Us[0][i1], Us[1][i2], Us[2][i3])
            * np.sqrt(r) + 0.4 * rng.standard_normal(
                len(i1)).astype(np.float32))
    return [(np.stack([i1, i2, i3], 1), vals)]


def _bench_fusion(nc, partners, r, seed):
    """bench.py:294-316 (``bench_fusion``)."""
    rng = np.random.default_rng(seed)
    Uc = rng.standard_normal((nc, r)) / np.sqrt(r)
    out = []
    for _, _, n2, nnz in partners:
        key = np.unique(rng.integers(0, nc * n2, int(nnz * 1.15)))[:nnz]
        i1, i2 = key // n2, key % n2
        V = rng.standard_normal((n2, r)) / np.sqrt(r)
        out.append((np.stack([i1, i2], 1),
                    np.sum(Uc[i1] * V[i2], axis=1) * np.sqrt(r)
                    + 0.4 * rng.standard_normal(nnz)))
    return out


FUSION_SMALL = (("ic50", "target", 50, 3_000), ("assay", "assay", 70, 2_000),
                ("pathway", "pathway", 20, 500))


@pytest.mark.parametrize("name", ["tensor", "tensor_big", "fusion"])
def test_graph_generators_equal_bench_sequence(monkeypatch, name):
    """``tensor_synthetic``, ``tensor_big_synthetic`` and
    ``fusion_synthetic``, summing 97 observations at a time, give the
    bytes of the JAX bench's own sequence (one pass, ``np.unique``)."""
    from bayesiandatafusion_jl_tpu_torch.models import datasets as tds
    monkeypatch.setattr(tds, "PRODUCT_CHUNK", 97)
    if name == "fusion":
        rd = tds.fusion_synthetic(300, FUSION_SMALL, rank=8, seed=6)
        got = [(rel.data.idx, rel.data.vals) for rel in rd.relations]
        want = _bench_fusion(300, FUSION_SMALL, 8, 6)
        assert [rel.name for rel in rd.relations] == ["ic50", "assay",
                                                      "pathway"]
    else:
        gen = (tds.tensor_synthetic if name == "tensor"
               else tds.tensor_big_synthetic)
        seed = 5 if name == "tensor" else 8
        df = gen((60, 50, 8), 1_000, rank=8, seed=seed)
        got = [(df.idx, df.vals)]
        want = (_bench_tensor if name == "tensor" else _bench_tensor_big)(
            (60, 50, 8), 1_000, 8, seed)
    assert len(got) == len(want)
    for (gi, gv), (wi, wv) in zip(got, want):
        assert len(gi) > 97
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gv, wv)
