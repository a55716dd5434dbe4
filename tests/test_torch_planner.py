"""The port's Gramian-path planner against the JAX package's.

``estimate_times``, ``plan_dense_modes`` and ``plan_fused_rels`` on random
relation statistics (arity 2 to 4, observation counts around the 50,000
floor, K, itemsizes, budgets that decline, ``per_mode_pairs``), with the
JAX package's TPU constants set into the port's module for the test (the
port's own are the card's, PERF.md §6): the same plans, stores and stderr
lines.  Then the engine: a float64 graph whose default plan mixes paths (a
relation dense on one mode and gather on the other, a fused relation, a
relation the budget sends to the gather path) against the JAX engine
under ``dense_gram=None`` with the same budget, and a default config under
the floor, which takes the gather path in both packages; 3 sweeps, U, mu
and Lambda to 1e-8."""
import contextlib
import io

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import bayesiandatafusion_jl_tpu as bdf
from bayesiandatafusion_jl_tpu.models.engine import MacauEngine
from bayesiandatafusion_jl_tpu.ops import dense_gram as jdg
from bayesiandatafusion_jl_tpu.utils.config import MacauConfig
import bayesiandatafusion_jl_tpu_torch as bt
from bayesiandatafusion_jl_tpu_torch.models import engine as torch_engine_mod
from bayesiandatafusion_jl_tpu_torch.ops import dense_gram as tdg
from test_torch_graph import _run_both

# the port's constant -> the JAX package's, which it stands for
JAX_CONSTANTS = {"_GATHER_S_PER_OBS": jdg._GATHER_S_PER_OBS,
                 "_HBM_BPS": jdg._HBM_BPS,
                 "_PAIR_I8_OPS": jdg._MXU_FLOPS,
                 "_PAIR_FLOAT_FLOPS": jdg._MXU_FLOPS,
                 "_FUSED_S8_OPS": jdg._BF16_FLOPS,
                 "_FUSED_FLOAT_FLOPS": jdg._BF16_FLOPS,
                 "_FUSED_F32_FLOPS": jdg._BF16_FLOPS}


@contextlib.contextmanager
def jax_constants():
    """The JAX package's planning constants in the port's module (a
    context manager, not a fixture: hypothesis reruns the test body)."""
    saved = {k: getattr(tdg, k) for k in JAX_CONSTANTS}
    for k, v in JAX_CONSTANTS.items():
        setattr(tdg, k, v)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(tdg, k, v)


def _both(fn_t, fn_j, *args, **kw):
    """(port's result, its stderr), (JAX's result, its stderr)."""
    out = []
    for fn in (fn_t, fn_j):
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            out.append((fn(*args, **kw), err.getvalue()))
    return out


def _plans(plans):
    return {k: (p.kind, p.n_focus, p.partner_counts)
            for k, p in plans.items()}


def test_floor_and_constants():
    """The floor is the JAX package's; every card constant is a positive
    rate or cost, and the constants' names cover the JAX ones."""
    assert tdg._AUTO_MIN_NNZ == jdg._AUTO_MIN_NNZ == 50_000
    assert all(getattr(tdg, k) > 0 for k in JAX_CONSTANTS)


@settings(max_examples=200, deadline=None)
@given(n_focus=st.integers(1, 10**6), np_comb=st.integers(1, 10**6),
       nnz=st.integers(0, 10**8), K=st.integers(1, 160),
       itemsize=st.sampled_from([1, 2, 4, 8]),
       rate=st.sampled_from([None, 1.1e14, 7e14]))
def test_estimate_times_matches_jax(n_focus, np_comb, nnz, K, itemsize,
                                    rate):
    with jax_constants():
        kw = {} if rate is None else dict(mxu_rate=rate)
        got = tdg.estimate_times(n_focus, np_comb, nnz, K, itemsize, **kw)
    assert got == jdg.estimate_times(n_focus, np_comb, nnz, K, itemsize,
                                     **kw)


_dims = st.integers(1, 3_000)
_relation = st.tuples(
    st.lists(_dims, min_size=2, max_size=4).map(tuple),
    st.one_of(st.just(0), st.integers(49_000, 51_000),
              st.integers(1, 10**7)))


@settings(max_examples=300, deadline=None)
@given(rels=st.lists(_relation, min_size=1, max_size=4),
       K=st.sampled_from([4, 8, 32, 33, 64, 96, 128]),
       dense_gram=st.sampled_from([None, True, False]),
       budget=st.floats(1e3, 1e11),
       itemsize=st.one_of(st.sampled_from([1, 2, 4, 8]),
                          st.lists(st.sampled_from([1, 2, 4, 8]),
                                   min_size=4, max_size=4)),
       per_mode_pairs=st.booleans())
def test_plan_dense_modes_matches_jax(rels, K, dense_gram, budget, itemsize,
                                      per_mode_pairs):
    """The same plans, canonical relations and copies, and the same
    stderr lines for every mode the budget declines."""
    shapes = [s for s, _ in rels]
    nnzs = [n for _, n in rels]
    with jax_constants():
        (got, err_t), (want, err_j) = _both(
            tdg.plan_dense_modes, jdg.plan_dense_modes, shapes, nnzs, K,
            dense_gram, budget, itemsize, per_mode_pairs=per_mode_pairs)
    assert _plans(got[0]) == _plans(want[0])
    assert got[1] == want[1] and got[2] == want[2]
    assert err_t == err_j


_enc = st.one_of(st.none(), st.tuples(st.sampled_from([0.5, 1.0, 0.0125]),
                                      st.integers(-3, 3)))


@settings(max_examples=300, deadline=None)
@given(rels=st.lists(st.tuples(
           st.lists(st.integers(1, 500_000), min_size=2, max_size=3)
           .map(tuple),
           st.one_of(st.just(0), st.integers(49_000, 51_000),
                     st.integers(1, 2 * 10**8)),
           _enc, st.sampled_from([1, 2, 4, 8])), min_size=1, max_size=4),
       K=st.sampled_from([4, 32, 64, 128]),
       dense_gram=st.sampled_from([None, True, False]),
       dense_fused=st.sampled_from([None, True, False]),
       budget=st.floats(1e6, 1e11))
def test_plan_fused_rels_matches_jax(rels, K, dense_gram, dense_fused,
                                     budget):
    """The same fused relations, bytes and stderr lines, on Netflix-sized
    relations too (whose pair does not fit while the one array does)."""
    shapes, nnzs, enc, its = (list(c) for c in zip(*rels))
    with jax_constants():
        (got, err_t), (want, err_j) = _both(
            tdg.plan_fused_rels, jdg.plan_fused_rels, shapes, nnzs, K,
            dense_gram, dense_fused, enc, its, budget)
    assert got == want and err_t == err_j


def test_plan_fused_rels_reads_on_demand():
    """The fused rule reads a relation's encoding and pair itemsize only
    where it needs them: none for a relation under the floor, no encoding
    where the pair fits the budget."""
    read = []

    class Spy:
        def __init__(self, tag, val):
            self.tag, self.val = tag, val

        def __getitem__(self, ri):
            read.append((self.tag, ri))
            return self.val

    shapes = [(1_000, 1_000), (10, 10), (480_189, 17_770)]
    nnzs = [1_000_000, 100, 100_000_000]
    out, spent = tdg.plan_fused_rels(shapes, nnzs, 32, None, None,
                                     Spy("enc", (1.0, 0)), Spy("its", 1),
                                     16e9)
    assert out == {2: (1.0, 0)} and spent == 480_189 * 17_770
    assert read == [("its", 0), ("its", 2), ("enc", 2)]


def _mixed_graph(pkg):
    """Four entities, three relations of 50,000 or more observations: A (u
    x v, 300 x 200, normal values), F (u x w, 300 x 250, half stars, one
    rating a cell: fused-encodable) and C (x x v, 1,000 x 200)."""
    rng = np.random.default_rng(11)
    u, v = pkg.Entity("u", count=300), pkg.Entity("v", count=200)
    w, x = pkg.Entity("w", count=250), pkg.Entity("x", count=1_000)
    rd = pkg.RelationData()

    def add(name, ents, nnz, half_stars=False):
        n0, n1 = ents[0].count, ents[1].count
        key = np.sort(rng.choice(n0 * n1, nnz, replace=False))
        vals = (rng.integers(2, 11, nnz) / 2.0 if half_stars
                else rng.standard_normal(nnz))
        rd.add_relation(pkg.IndexedDF(np.stack([key // n1, key % n1], 1),
                                      vals, (n0, n1)), name, ents)
    add("A", [u, v], 55_000)
    add("F", [u, w], 60_000, half_stars=True)
    add("C", [x, v], 52_000)
    rd.assign_to_test("A", 500, seed=7)
    return rd


# 1.1 MB: F's float64 pair (1.2 MB) does not fit and its one array (75 kB)
# does; then A's pair (0.96 MB) fits what is left and C's (3.2 MB) not
MIXED_BUDGET_GB = 0.0011


def test_default_plan_mixes_paths_matches_jax_engine(monkeypatch):
    """``dense_gram=None`` and ``dense_fused=None`` with the same budget,
    the JAX constants in the port's planner: both engines plan F fused, A
    dense and C on the gather path (declined by the budget, a stderr line
    in each).  The JAX cost model is the same for every mode of a
    relation, so a relation splits only where the costs differ: both
    planners get one cost model that prices A's mode 1 (focus v, 200 rows
    against 300) as free on the gather path, and both then keep A's pair
    for mode 0 alone.  Equal plans, then 3 float64 sweeps to 1e-8."""
    for k, val in JAX_CONSTANTS.items():
        monkeypatch.setattr(tdg, k, val)
    for mod in (tdg, jdg):
        est = mod.estimate_times

        def split(n_focus, np_comb, nnz, K, itemsize, _est=est, **kw):
            d, g = _est(n_focus, np_comb, nnz, K, itemsize, **kw)
            return (d, 0.0) if (n_focus, np_comb) == (200, 300) else (d, g)
        monkeypatch.setattr(mod, "estimate_times", split)
    common = dict(num_latent=3, dtype="float64", seed=5, verbose=False,
                  dense_gram_budget_gb=MIXED_BUDGET_GB)
    ej = MacauEngine(_mixed_graph(bdf), MacauConfig(pallas="off", **common))
    et = bt.MacauEngine(_mixed_graph(bt), bt.MacauConfig(**common),
                        device="cpu")
    want = _plans(ej.problem.dense_plans)
    assert _plans(et.problem.dense_plans) == want == {
        (0, 0): ("canonical", 300, (200,)),
        (1, 0): ("fused", 300, (250,)), (1, 1): ("fused", 250, (300,))}
    prob = et.problem
    assert prob.kinds == ["pair", "fused", "gather"]
    assert not prob.pair_i8s[0] and not prob.fused_i8s[1]
    assert set(prob.layouts) == {"r0m1", "r2m0", "r2m1"}
    assert prob.plan.store_bytes == {0: 2 * 300 * 200 * 8.0,
                                     1: 300 * 250.0}
    _run_both(ej, et)


def test_default_plan_matches_jax_engine_without_patches(capfd):
    """The same graph with the JAX constants and cost model as they are:
    both planners keep A's pair for both modes, F fused, C declined."""
    common = dict(num_latent=3, dtype="float64", seed=5, verbose=False,
                  dense_gram_budget_gb=MIXED_BUDGET_GB)
    with jax_constants():
        et = bt.MacauEngine(_mixed_graph(bt), bt.MacauConfig(**common),
                            device="cpu")
    ej = MacauEngine(_mixed_graph(bdf), MacauConfig(pallas="off", **common))
    assert _plans(et.problem.dense_plans) == _plans(ej.problem.dense_plans)
    assert set(et.problem.dense_plans) == {(0, 0), (0, 1), (1, 0), (1, 1)}
    err = capfd.readouterr().err
    assert err.count("relation 2 mode 0 declined by budget") == 2


@pytest.mark.parametrize("dense_int8", [False, True])
def test_under_floor_default_takes_gather(dense_int8):
    """A default config on a relation under 50,000 observations: no dense
    plan in either package; the port builds the gather layouts of both
    modes and no store.  3 float64 sweeps to 1e-8."""
    def graph(pkg):
        rng = np.random.default_rng(2)
        mask = rng.random((120, 90)) < 0.4
        idx = np.stack(np.nonzero(mask), 1)
        rd = pkg.RelationData.from_indexed_df(pkg.IndexedDF(
            idx, rng.integers(1, 6, len(idx)).astype(float), (120, 90)))
        rd.assign_to_test(0, 200, seed=7)
        return rd
    common = dict(num_latent=4, dtype="float64", seed=5, verbose=False,
                  dense_int8=dense_int8)
    ej = MacauEngine(graph(bdf), MacauConfig(pallas="off", **common))
    et = bt.MacauEngine(graph(bt), bt.MacauConfig(**common), device="cpu")
    assert not ej.problem.dense_plans and not et.problem.dense_plans
    assert et.problem.kinds == ["gather"] and et.problem.stores == [None]
    assert set(et.problem.layouts) == {"r0m0", "r0m1"}
    _run_both(ej, et)


def test_plan_gramians_is_what_the_engine_builds():
    """``plan_gramians`` decides without building anything, and the
    engine builds what it says; the bench-shaped budgets: an int8 pair of
    relation statistics alone (true extents, never the padded store)."""
    rd = _mixed_graph(bt)
    cfg = bt.MacauConfig(num_latent=3, dtype="float64", verbose=False,
                         dense_gram_budget_gb=MIXED_BUDGET_GB)
    plan = torch_engine_mod.plan_gramians(rd, cfg)
    eng = bt.MacauEngine(rd, cfg, device="cpu")
    assert _plans(plan.dense_plans) == _plans(eng.problem.dense_plans)
    assert set(plan.fused) == {1} and plan.pair_i8 == {0: False}
    assert plan.fused[1][2].all()
    i8 = torch_engine_mod.plan_gramians(
        rd, bt.MacauConfig(num_latent=3, verbose=False, dense_int8=True,
                           dense_gram=True))
    # one byte a cell of M8 and W8 on the true extents (the store pads its
    # first and last axes to 16)
    assert i8.pair_i8 == {0: True, 1: True, 2: True}
    assert i8.store_bytes == {0: 2 * 300 * 200.0, 1: 2 * 300 * 250.0,
                              2: 2 * 1_000 * 200.0}


# bench.py's configurations by their relation statistics (true extents,
# training observations after each bench's test split), K = 32, the int8
# pair's itemsize (every bench config sets dense_int8=True): the path the
# port's planner, on the card's constants and default budget, must give
# every mode
BENCH_RELATIONS = {
    "ml10m": ([(71_567, 10_681)], [9_900_054], "pair"),
    "tensor": ([(30_000, 2_000, 16)], [4_900_000], "pair"),
    "fusion": ([(50_000, 500), (50_000, 3_000), (50_000, 800)],
               [4_900_000, 4_000_000, 1_000_000], "pair"),
    "chembl": ([(15_000, 346)], [270_000], "pair"),
    "tensor_big": ([(200_000, 20_000, 8)], [29_900_000], "gather"),
    "netflix": ([(480_189, 17_770)], [100_380_507], "fused"),
}


@pytest.mark.parametrize("name", sorted(BENCH_RELATIONS))
def test_bench_plans_on_card_constants(name):
    """``plan_fused_rels`` then ``plan_dense_modes`` as the engine calls
    them, on the card's constants and the config's default budget."""
    shapes, nnzs, want = BENCH_RELATIONS[name]
    budget = bt.MacauConfig().dense_gram_budget_gb * 1e9
    enc = [(1.0, 0)] * len(shapes)         # a star grid encodes exactly
    fused, spent = tdg.plan_fused_rels(shapes, nnzs, 32, None, None, enc,
                                       [1] * len(shapes), budget)
    plans, canonical, _ = tdg.plan_dense_modes(
        shapes, [0 if ri in fused else n for ri, n in enumerate(nnzs)], 32,
        None, budget - spent, 1)
    paths = {("fused" if ri in fused else "pair" if (ri, m) in plans
              else "gather") for ri, s in enumerate(shapes)
             for m in range(len(s))}
    assert paths == {want}


# the float32 FMA kernel's rate at Netflix (its ML-10M K = 32 times scaled
# by the cells, ~470 ms a mode), which the three-piece kernel replaced
FMA_F32_FLOPS = 1.9e13


@pytest.mark.parametrize("rate, want", [(None, {0: (1.0, 0)}),
                                        (FMA_F32_FLOPS, {})])
def test_netflix_defaults_price_the_float32_table(monkeypatch, rate, want):
    """The defaults (float32, ``dense_int8=False``, no ``gram_dtype``)
    give the Netflix relation a float32 pair (68 GB, past the budget): the
    fused store is then priced at the float32 table's own rate,
    ``_FUSED_F32_FLOPS``.  On the card's constants it takes the fused
    store; at the FMA kernel's rate it would not."""
    if rate is not None:
        monkeypatch.setattr(tdg, "_FUSED_F32_FLOPS", rate)
    shapes, nnzs, _ = BENCH_RELATIONS["netflix"]
    budget = bt.MacauConfig().dense_gram_budget_gb * 1e9
    assert 2.0 * shapes[0][0] * shapes[0][1] * 4 > budget
    fused, spent = tdg.plan_fused_rels(shapes, nnzs, 32, None, None,
                                       [(1.0, 0)], [4], budget)
    assert fused == want
    assert spent == (shapes[0][0] * shapes[0][1] if want else 0.0)
