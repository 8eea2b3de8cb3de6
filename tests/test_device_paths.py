"""Large-batch device paths vs their host formulations.

The sum-product count accumulators switch to fused device kernels at 512
columns (real spectra) with a real/imag-decomposed variant for complex
eigensystems; the column-likelihood memo and device row gathers must be
value-identical to the uncached host reads.  None of the golden tests
reach these thresholds, so they are pinned here.
"""

import os

import numpy as np
import pytest

from historian_tpu.core import alignpath as AP
from historian_tpu.core.tree import Tree
from historian_tpu.engine.sumprod import SumProductEngine
from historian_tpu.models.ratemodel import RateModel

TREE = "((a:0.3,b:0.2):0.1,(c:0.4,d:0.15):0.25);"


def _random_rows(model, tree, L, seed):
    rng = np.random.default_rng(seed)
    alphabet = model.alphabet
    syms = [alphabet.symbol(i) for i in range(alphabet.size)]
    rows = []
    for n in range(tree.n_nodes()):
        if tree.is_leaf(n):
            rows.append(
                "".join(
                    rng.choice(syms) if rng.random() > 0.15 else "-" for _ in range(L)
                )
            )
        else:
            rows.append("*" * L)
    return rows


def _host_accumulated(engine, rows, weights, chunk=400):
    """Host-path accumulation: sub-512-column fills stay on the numpy
    formulation; their per-column contributions are independent, so the
    chunked sum equals the one-batch result."""
    c, a = engine.model.components, engine.model.alphabet_size
    root = np.zeros((c, a))
    eig = np.zeros((c, a, a), dtype=np.complex128)
    L = len(rows[0])
    for lo in range(0, L, chunk):
        sub = [r[lo : lo + chunk] for r in rows]
        fill = engine.fill(sub)
        fill.accumulate_eigen_counts(root, eig, weights[lo : lo + chunk])
    return root, eig


@pytest.mark.parametrize(
    "model_file",
    ["testcount.jukescantor.json", "testamino.json"],
    ids=["real-spectrum", "complex-spectrum"],
)
def test_device_eigen_counts_match_host(ref_data, model_file):
    model = RateModel.from_file(os.path.join(ref_data, model_file))
    tree = Tree(TREE)
    engine = SumProductEngine(model, tree)
    L = 700  # over the 512-column device threshold
    rows = _random_rows(model, tree, L, seed=3)
    rng = np.random.default_rng(4)
    weights = rng.random(L)

    c, a = model.components, model.alphabet_size
    root_dev = np.zeros((c, a))
    eig_dev = np.zeros((c, a, a), dtype=np.complex128)
    fill = engine.fill(rows)
    assert fill.n_columns >= 512
    fill.accumulate_eigen_counts(root_dev, eig_dev, weights)

    root_host, eig_host = _host_accumulated(engine, rows, weights)
    np.testing.assert_allclose(root_dev, root_host, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(eig_dev, eig_host, rtol=1e-9, atol=1e-12)


def test_column_ll_cache_matches_uncached(ref_data):
    model = RateModel.from_file(os.path.join(ref_data, "testamino.json"))
    tree = Tree(TREE)
    engine = SumProductEngine(model, tree)
    rows = _random_rows(model, tree, 90, seed=5)

    uncached = engine.column_log_likelihoods(rows)
    cached = engine.column_log_likelihoods_cached(rows)
    np.testing.assert_array_equal(cached, uncached)

    # warm repeat
    np.testing.assert_array_equal(engine.column_log_likelihoods_cached(rows), uncached)

    # a single new column must not take the (unpadded) L=1 fill path,
    # whose values differ from the padded buckets
    mutated = list(rows)
    leaf = next(n for n in range(tree.n_nodes()) if tree.is_leaf(n))
    row = list(mutated[leaf])
    row[7] = "-" if row[7] != "-" else model.alphabet.symbol(0)
    mutated[leaf] = "".join(row)
    np.testing.assert_array_equal(
        engine.column_log_likelihoods_cached(mutated),
        engine.column_log_likelihoods(mutated),
    )


def test_rows_at_matches_host_tensors(ref_data):
    model = RateModel.from_file(os.path.join(ref_data, "testcount.jukescantor.json"))
    tree = Tree(TREE)
    engine = SumProductEngine(model, tree)
    rows = _random_rows(model, tree, 130, seed=6)
    fill = engine.fill(rows)
    cols = np.array([0, 3, 17, 64, 129], dtype=np.int64)
    for name in ("E", "logE", "G", "logG"):
        fresh = engine.fill(rows)  # unmaterialized host tensors
        got = fresh.rows_at(name, cols, 1)
        want = getattr(fill, name)[cols, 1]
        np.testing.assert_array_equal(got, want)


def test_fill_cached_reuses_until_rows_change(ref_data):
    model = RateModel.from_file(os.path.join(ref_data, "testcount.jukescantor.json"))
    tree = Tree(TREE)
    engine = SumProductEngine(model, tree)
    rows = _random_rows(model, tree, 40, seed=7)
    f1 = engine.fill_cached(rows)
    assert engine.fill_cached(list(rows)) is f1
    mutated = [rows[0].replace(rows[0][0], "-", 1)] + rows[1:]
    assert engine.fill_cached(mutated) is not f1


@pytest.mark.parametrize(
    "model_file",
    ["testamino.json", "testrates.mix2.json"],
    ids=["one-component", "two-component"],
)
def test_native_sumprod_fill_matches_device(ref_data, model_file):
    """The native host fill (small batches) against the device scan,
    including gapped internals (sub-forest columns) and the down pass."""
    import os

    from historian_tpu.native import get_native

    if get_native() is None:
        pytest.skip("native runtime unavailable")
    from historian_tpu.ops.felsenstein import tokenize_alignment

    model = RateModel.from_file(os.path.join(ref_data, model_file))
    tree = Tree(TREE)
    engine = SumProductEngine(model, tree)
    rng = np.random.default_rng(9)
    alphabet = model.alphabet
    syms = [alphabet.symbol(i) for i in range(alphabet.size)]
    L = 150
    rows = []
    for n in range(tree.n_nodes()):
        if tree.is_leaf(n):
            rows.append("".join(rng.choice(syms) if rng.random() > 0.25 else "-" for _ in range(L)))
        else:
            rows.append("".join("*" if rng.random() > 0.3 else "-" for _ in range(L)))
    toks = tokenize_alignment(alphabet, rows)
    nat = engine._native_fill(toks)
    assert nat is not None
    os.environ["HISTORIAN_DEVICE_SUMPROD"] = "1"
    try:
        dev = engine.fill_tokens(toks)
    finally:
        os.environ.pop("HISTORIAN_DEVICE_SUMPROD")
    for name in ("F", "logF", "E", "logE", "G", "logG", "cpt_ll", "col_ll"):
        np.testing.assert_allclose(
            getattr(nat, name), getattr(dev, name), rtol=1e-9, atol=1e-12, err_msg=name
        )


def test_native_merge_matches_python_fuzz():
    rng = np.random.default_rng(11)
    if AP._native_merge([], {}, []) is None and os.environ.get("HISTORIAN_NATIVE") == "0":
        pytest.skip("native runtime disabled")

    def rand_master(rows, rng):
        L = int(rng.integers(4, 16))
        out = {r: rng.random(L) < 0.6 for r in rows}
        keep = np.stack(list(out.values())).any(axis=0)
        return {r: v[keep] for r, v in out.items()}

    checked = 0
    for _ in range(120):
        master_rows = list(range(int(rng.integers(3, 9))))
        master = rand_master(master_rows, rng)

        def proj(rows):
            sub = {r: master[r] for r in rows}
            keep = np.stack(list(sub.values())).any(axis=0)
            return {r: v[keep] for r, v in sub.items()}

        k1 = int(rng.integers(2, len(master_rows) + 1))
        k2 = int(rng.integers(2, len(master_rows) + 1))
        a1 = proj(list(rng.choice(master_rows, size=k1, replace=False)))
        a2 = proj(list(rng.choice(master_rows, size=k2, replace=False)))
        if not a1 or not a2:
            continue
        if not len(next(iter(a1.values()))) or not len(next(iter(a2.values()))):
            continue
        nat = AP.align_path_merge([a1, a2])
        orig = AP._native_merge
        AP._native_merge = lambda *a, **k: None
        try:
            py = AP.align_path_merge([a1, a2])
        finally:
            AP._native_merge = orig
        assert set(nat) == set(py)
        for r in py:
            np.testing.assert_array_equal(nat[r], py[r])
        checked += 1
    assert checked > 50


def test_rows_at_native_fill_never_touches_jax(ref_data, monkeypatch):
    """A native (host numpy) sum-product fill's rows_at must index with
    numpy only: a jnp index array silently commits the tiny cols array
    to the DEFAULT device, one device round trip per read in a loop
    that MCMC runs per proposal."""
    import historian_tpu.engine.sumprod as sp

    model = RateModel.from_file(os.path.join(ref_data, "testcount.jukescantor.json"))
    tree = Tree(TREE)
    engine = SumProductEngine(model, tree)
    rows = _random_rows(model, tree, 60, seed=8)
    fill = engine.fill(rows)
    assert isinstance(fill._device.get("F"), np.ndarray), "expected a native fill"

    def boom(*a, **k):
        raise AssertionError("jnp.asarray on a host-tensor rows_at path")

    monkeypatch.setattr(sp.jnp, "asarray", boom)
    cols = np.array([0, 5, 11], dtype=np.int64)
    got = fill.rows_at("E", cols, 1)
    assert got.shape[0] == 3
