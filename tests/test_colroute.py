"""The col route (chain x against a profile DAG y) and what surrounds it.

The route's column scan runs as XLA's lax.scan here and as the CUDA
kernel (native_src/colforward.cu) on a GPU.  These tests pin, on the CPU:

- the XLA route against the host native f64 fill, on LG merges built
  from the committed long8 corpus (chain x sampled-profile DAG with
  in-edges reaching far back, and chain x chain), in f64 and in the
  GPU's f32;
- the CUDA wrapper's operand packing, build command and kernel choice;
- the platform flag, the compile-cache location, the matmul precision
  and the device-memory budget.

The kernel itself needs the card: test_cuda_kernel_matches_xla is marked
`gpu` and skips here.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data")


def _merge(kind: str):
    """A host-filled LG merge from long8 prefixes (150 aa per leaf)."""
    from historian_tpu.core.seqs import FastSeq, read_fasta
    from historian_tpu.engine.forward import ForwardMatrix
    from historian_tpu.engine.pairhmm import PairHMM
    from historian_tpu.engine.profile import Profile
    from historian_tpu.models.presets import named_model
    from historian_tpu.models.ratemodel import ProbModel
    from historian_tpu.utils.rng import MT19937

    model = named_model("lg")
    seqs = [FastSeq(name=s.name, seq=s.seq[:150])
            for s in read_fasta(os.path.join(DATA, "long8.fa"))]

    def prof(i):
        return Profile.from_sequence(model.components, model.alphabet, seqs[i], i)

    def hmm(a, b):
        return PairHMM(ProbModel(model, a), ProbModel(model, b), model.ins_prob)

    if kind == "chain_x_dag":
        # leaves from the two subtrees: their sampled paths diverge, so
        # the profile is a DAG whose in-edges reach many columns back
        f04 = ForwardMatrix(prof(0), prof(4), hmm(0.3, 0.3), 8)
        y = f04.sample_profile(MT19937(5489), 100, 0)
        return ForwardMatrix(prof(2), y, hmm(0.3, 0.7), 9)
    return ForwardMatrix(prof(0), prof(5), hmm(0.4, 0.4), 9)


@pytest.mark.parametrize("dtype,rtol", [("f64", 1e-9), ("f32", 1e-5)])
@pytest.mark.parametrize("kind", ["chain_x_dag", "chain_x_chain"])
def test_xla_col_route_matches_host_fill(kind, dtype, rtol, monkeypatch):
    from historian_tpu.ops import devicedp

    monkeypatch.setenv("HISTORIAN_DEVICE_DP", "0")
    host = _merge(kind)
    ay = devicedp._profile_dag_arrays(host.y, host.y_size - 1)
    reach = (np.arange(host.y_size - 1)[:, None] - ay["src"])[ay["lp"] > devicedp.NEG / 2]
    if kind == "chain_x_dag":
        assert host.y.as_chain() is None and reach.max() > 8
    monkeypatch.setenv("HISTORIAN_DEVICE_DP", "1")
    monkeypatch.setenv("HISTORIAN_DEVICE_DTYPE", dtype)
    assert devicedp.col_kernel() == "xla"
    cells = devicedp.col_forward_cells(host)
    ref = host.cells[: host.x_size - 1, : host.y_size - 1]
    live = np.isfinite(ref)
    assert np.array_equal(np.isfinite(cells), live)
    rel = np.abs(cells[live] - ref[live]) / np.maximum(np.abs(ref[live]), 1.0)
    assert rel.max() <= rtol, rel.max()
    lp_end = devicedp.col_forward_device(host).lp_end
    assert abs(lp_end - host.lp_end) <= rtol * abs(host.lp_end)


def test_cuda_operands_pack_the_xla_inputs():
    """The kernel's operands carry exactly the XLA scan's inputs: gates
    as 0/NEG, y flags as 0/1 columns, shapes and dtypes preserved."""
    import jax.numpy as jnp

    from historian_tpu.ops.cuda_colforward import NEG, kernel_operands

    SY, SX, KY = 6, 10, 3
    rng = np.random.default_rng(0)
    v = dict(
        rsx=rng.normal(size=SX), isx=rng.normal(size=SX),
        rsy=rng.normal(size=SY), isy=rng.normal(size=SY),
        trans=rng.normal(size=23),
        x_ready=rng.random(SX) < 0.5, x_eos=rng.random(SX) < 0.5,
        y_src=rng.integers(0, SY, (SY, KY)), y_lp=rng.normal(size=(SY, KY)),
        y_null=rng.random(SY) < 0.5, y_ready=rng.random(SY) < 0.5,
    )
    absorb = rng.normal(size=(SY, SX)).astype(np.float32)
    mask = rng.random((SY, SX)) < 0.7
    ops = kernel_operands(jnp.asarray(absorb), jnp.asarray(mask),
                          {k: jnp.asarray(x) for k, x in v.items()})
    a, maskg, xvec, yvec, y_src, y_lp, trans = (np.asarray(o) for o in ops)
    assert [o.shape for o in (a, maskg, xvec, yvec, y_src, y_lp, trans)] == [
        (SY, SX), (SY, SX), (4, SX), (SY, 4), (SY, KY), (SY, KY), (23,)]
    assert all(o.dtype == np.float32 for o in (a, maskg, xvec, yvec, y_lp, trans))
    assert y_src.dtype == np.int32
    np.testing.assert_array_equal(maskg, np.where(mask, 0, np.float32(NEG)))
    np.testing.assert_array_equal(xvec[2], np.where(v["x_ready"], 0, np.float32(NEG)))
    np.testing.assert_array_equal(xvec[3], np.where(v["x_eos"], 0, np.float32(NEG)))
    np.testing.assert_allclose(xvec[0], v["rsx"].astype(np.float32))
    np.testing.assert_array_equal(yvec[:, 0], v["y_null"].astype(np.float32))
    np.testing.assert_array_equal(yvec[:, 1], v["y_ready"].astype(np.float32))
    np.testing.assert_allclose(yvec[:, 3], v["isy"].astype(np.float32))


def test_cuda_build_is_keyed_by_source_and_targets_hopper():
    from historian_tpu.ops import cuda_colforward as cc

    path = cc.lib_path()
    assert os.path.dirname(path).startswith(os.path.join(REPO, "historian_tpu"))
    assert path == cc.lib_path()  # stable for one source
    cmd = cc.build_command("out.so")
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert cmd[-1].endswith("colforward.cu") and os.path.exists(cmd[-1])


def test_col_kernel_choice(monkeypatch):
    from historian_tpu.ops import devicedp

    monkeypatch.delenv("HISTORIAN_COL_KERNEL", raising=False)
    assert devicedp.col_kernel() == "xla"  # CPU backend
    monkeypatch.setattr(devicedp, "backend_kind", lambda: "gpu")
    assert devicedp.col_kernel() == "cuda"
    monkeypatch.setenv("HISTORIAN_COL_KERNEL", "xla")
    assert devicedp.col_kernel() == "xla"
    monkeypatch.setenv("HISTORIAN_COL_KERNEL", "pallas")
    with pytest.raises(ValueError):
        devicedp.col_kernel()


@pytest.mark.gpu
def test_cuda_kernel_matches_xla():
    """On the card: the CUDA scan against XLA's, chain and DAG y."""
    import jax.numpy as jnp

    sys.path.insert(0, os.path.join(REPO, "tools"))
    from bench_colforward import rel_err, synthetic_merge

    from historian_tpu.ops import colforward

    for ky in (1, 4):
        absorb, mask, v = synthetic_merge(1024, 96, ky)
        args = (jnp.asarray(absorb), jnp.asarray(mask),
                {k: jnp.asarray(x) for k, x in v.items()})
        got = np.asarray(colforward.fill_planes(*args, kernel="cuda"))
        ref = np.asarray(colforward.fill_planes(*args, kernel="xla"))
        assert rel_err(got, ref) < 1e-5


def _cli(args, env_extra=None):
    env = {k: v for k, v in os.environ.items() if k != "HISTORIAN_PLATFORM"}
    env.update(env_extra or {})
    return subprocess.run(
        [sys.executable, "-m", "historian_tpu", *args],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120,
    )


@pytest.mark.parametrize("flag", [["-platform", "gpu"], ["-platform", "rocm"]])
def test_platform_without_device_exits_nonzero(flag):
    r = _cli([*flag, "version"])
    if flag[1] == "gpu" and r.returncode == 0 and os.path.exists("/dev/nvidia0"):
        pytest.skip("this host has a GPU")
    assert r.returncode != 0
    assert flag[1] in r.stderr.lower() and "historian-tpu 0.1.0" not in r.stdout


def test_compile_cache_dir(tmp_path):
    from historian_tpu.ops import compile_cache_dir

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        assert compile_cache_dir().startswith(os.path.join(REPO, ".jax_cache"))
    code = (
        "import jax, historian_tpu.ops as o; "
        "print(jax.config.jax_compilation_cache_dir); print(o.compile_cache_dir())"
    )
    env = dict(os.environ, JAX_COMPILATION_CACHE_DIR=str(tmp_path))
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == [str(tmp_path), str(tmp_path)]


def _dots(lowered_text: str) -> list[str]:
    return [ln for ln in lowered_text.splitlines() if "dot_general" in ln]


def test_likelihood_matmuls_lower_at_highest_precision():
    import jax.numpy as jnp

    from historian_tpu.ops import devicedp
    from historian_tpu.ops.felsenstein import _fill_up_batch

    f32 = jnp.float32
    absorb = devicedp._factored_absorb().lower(
        jnp.ones((8, 4), f32), jnp.ones((6, 4), f32), jnp.zeros(8, f32),
        jnp.zeros(6, f32), jnp.arange(5, dtype=jnp.int32),
    ).as_text()
    L, N, C, A = 4, 3, 2, 4
    fel = _fill_up_batch.lower(
        jnp.ones((L, N, A), f32), jnp.zeros((L, N), bool),
        jnp.array([2, 2, -1], jnp.int32), jnp.array([-1, -1, 0], jnp.int32),
        jnp.array([-1, -1, 1], jnp.int32), jnp.ones((N, C, A, A), f32),
        jnp.ones((C, A), f32), jnp.zeros(C, f32), n_nodes=N,
    ).as_text()
    for text in (absorb, fel):
        dots = _dots(text)
        assert dots and all("precision = [HIGHEST, HIGHEST]" in d for d in dots), dots


@pytest.mark.parametrize(
    "limit,env,expect",
    [(None, None, 3072.0), (16e9, None, 3200.0), (60e9, None, 12000.0),
     (60e9, "512", 512.0)],
)
def test_planes_budget_from_bytes_limit(limit, env, expect, monkeypatch):
    from historian_tpu.ops import devicedp

    if env is None:
        monkeypatch.delenv("HISTORIAN_TRACE_PLANES_MB", raising=False)
    else:
        monkeypatch.setenv("HISTORIAN_TRACE_PLANES_MB", env)
    assert devicedp.planes_budget_mb(limit) == pytest.approx(expect)
