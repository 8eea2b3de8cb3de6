"""Guard: every bench.py extras probe runs clean on a tiny workload.

A lazy-property refactor once broke the probes' perturb paths and
nothing in the battery exercised them, so a bench record carried
"error: ..." strings instead of numbers.  Each probe takes tiny=True,
which shrinks its workload to milliseconds; this test runs all of them
on the CPU backend and asserts no section -- at any nesting depth --
carries an "error:" payload.
"""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench  # noqa: E402


def _assert_no_errors(obj, path="$"):
    if isinstance(obj, str):
        assert "error:" not in obj, f"{path} carries an error payload: {obj!r}"
    elif isinstance(obj, dict):
        for k, v in obj.items():
            _assert_no_errors(v, f"{path}.{k}")
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            _assert_no_errors(v, f"{path}[{i}]")


@pytest.mark.parametrize(
    "probe",
    [
        "bench_roofline",
        "bench_production_col_kernel",
        "bench_router_crossover",
        "bench_fit_estep",
        "bench_mcmc_router",
        "bench_mcmc_batch",
        "bench_tropical",
    ],
)
def test_extras_probe_runs_clean(probe):
    out = getattr(bench, probe)(tiny=True)
    assert isinstance(out, dict), f"{probe} returned {type(out)}"
    _assert_no_errors(out, probe)


def test_codon_probe_runs_clean():
    out = bench.bench_codon(tiny=True)
    assert isinstance(out, dict)
    _assert_no_errors(out, "bench_codon")
