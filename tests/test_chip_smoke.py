"""chip_smoke.py's phases at tiny size on the CPU, and its refusal to
run its main path without a GPU."""

import os
import sys

import jax
import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

NT_ARGS = ["-m", "GTR", "-c", "4", "-a", "e", "-o", "tlr", "-s", "SPR",
           "-b", "0", "--r_seed", "1"]


@pytest.fixture
def restore_platforms():
    keep = jax.config.jax_platforms
    keep_cache = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_platforms", keep)
    jax.config.update("jax_compilation_cache_dir", keep_cache)


def test_main_refuses_the_cpu(restore_platforms, capsys):
    with pytest.raises(RuntimeError, match="gpu"):
        chip_smoke.main([])
    assert '"ok"' not in capsys.readouterr().out


def test_device_phase():
    info = chip_smoke.device_phase("cpu")
    assert info == {"platform": "cpu", "kind": jax.devices()[0].device_kind,
                    "count": len(jax.devices())}
    with pytest.raises(AssertionError):
        chip_smoke.device_phase("gpu")


@pytest.mark.parametrize("datatype", ["nt", "aa"])
def test_likelihood_phase_tiny(datatype):
    out = chip_smoke.likelihood_phase(datatype, n_taxa=10, n_sites=90)
    assert abs(out["lnl"] - out["lnl_ref"]) < chip_smoke.LNL_TOL
    assert out["loglik_ms"] > 0


def test_blen_phase_tiny():
    lnl = chip_smoke.blen_phase(n_taxa=10, n_sites=90, target=None)
    assert np.isfinite(lnl)


@pytest.mark.parametrize("datatype,args", [
    ("nt", NT_ARGS),
    ("aa", ["-m", "LG", "-c", "4", "-a", "e", "-o", "lr"]),
])
def test_cli_phase_tiny(restore_platforms, datatype, args):
    lnl = chip_smoke.cli_phase(datatype, args, n_taxa=8, n_sites=80,
                               platform="cpu", optimum=None)
    assert np.isfinite(lnl)


def test_four_phase_tiny_on_cpu_processes():
    """The farm with 2 CPU processes against 1: identical supports."""
    out = chip_smoke.four_phase(n_procs=2, n_taxa=8, n_sites=80,
                                n_boot=2, platform="cpu", timeout=600)
    assert out["wall_n"] > 0 and out["wall_1"] > 0


def test_result_parsers(tmp_path):
    tree = tmp_path / "t.txt"
    tree.write_text("((a:0.1,b:0.2)87:0.05,(c:0.1,d:0.1)100:0.2,e:0.3);\n")
    nwk, sup = chip_smoke._supports(str(tree))
    assert sup == [87.0, 100.0] and nwk.endswith(";")
    stats = tmp_path / "s.txt"
    stats.write_text(". Model of nucleotides substitution: \tGTR\n"
                     ". Log-likelihood: \t\t\t-1234.56789\n")
    assert chip_smoke._stats_lnl(str(stats)) == -1234.56789


def test_compile_clock_counts():
    import jax.numpy as jnp

    clock = chip_smoke.CompileClock()
    before = clock.total
    jax.jit(lambda x: x * 3.0 + 1.0)(jnp.arange(7.0)).block_until_ready()
    assert clock.total > before
