"""Generic (custom-alphabet) datatype, --codpos and --aa_rate_file.

Reference: -d generic (cl.c:929-932) runs JC69 over a "natural
numbers" alphabet with uniform frequencies (init.c:1519-1533);
--codpos keeps one codon position (utilities.c:175
Restrict_To_Coding_Position); --aa_rate_file loads a PAML-format
custom AA matrix (CUSTOMAA, cl.c:560-570).

NOTE: the reference binary's own `-d generic` is bit-rotted - on a
4-state digit alignment it dies with `eigen.c:53: Eigen: Assertion
isnan(A[i]) == NO failed` (verified 2026-08-21 against the v3.3.2026
build), so golden parity is established through the JC69 equivalence
below instead (a 4-state generic alignment must score EXACTLY like
the corresponding DNA alignment under JC69, which IS golden-verified
elsewhere).
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

from conftest import EXAMPLES


def _write_phylip(path, names, seqs):
    with open(path, "w") as fh:
        fh.write(f" {len(names)} {len(seqs[0])}\n")
        for n, s in zip(names, seqs):
            fh.write(f"{n:<10s}{s}\n")


NT2DIGIT = str.maketrans("ACGT", "0123")


def test_generic_matches_jc69(tmp_path):
    """A 4-state generic alignment that mirrors a DNA alignment must
    give EXACTLY the JC69 log-likelihood (same states, same model)."""
    from phyml_tpu import (
        LikelihoodEngine, SubstModel, Topology, read_alignment,
    )
    from phyml_tpu.ops.likelihood import tree_arrays

    rng = np.random.default_rng(0)
    names = [f"t{i}" for i in range(8)]
    nt_seqs = ["".join(rng.choice(list("ACGT"), 60)) for _ in names]
    gen_seqs = [s.translate(NT2DIGIT) for s in nt_seqs]
    p_nt = tmp_path / "nt.phy"
    p_gen = tmp_path / "gen.phy"
    _write_phylip(p_nt, names, nt_seqs)
    _write_phylip(p_gen, names, gen_seqs)

    aln_nt = read_alignment(str(p_nt), datatype="nt")
    aln_gen = read_alignment(str(p_gen), datatype="generic")
    assert aln_gen.partials.shape[-1] == 4

    topo = Topology.random(8, np.random.default_rng(1), mean_blen=0.1)
    m_nt = SubstModel(datatype="nt", name="JC69", n_classes=4)
    m_gen = SubstModel(datatype="generic", generic_ns=4, n_classes=4)
    e_nt = LikelihoodEngine(aln_nt, m_nt, dtype=jnp.float64)
    e_gen = LikelihoodEngine(aln_gen, m_gen, dtype=jnp.float64)
    ta = tree_arrays(topo.rooted(), dtype=jnp.float64)
    l_nt = float(e_nt.loglik(m_nt.init_params(), ta))
    l_gen = float(e_gen.loglik(m_gen.init_params(), ta))
    assert abs(l_nt - l_gen) < 1e-9, (l_nt, l_gen)


def test_generic_ambiguity_and_ns_inference(tmp_path):
    from phyml_tpu import datatypes

    enc, ns = datatypes.encode_generic(["012?", "01-5"])
    assert ns == 6
    assert enc.shape == (2, 4, 6)
    # '?' and '-' are full ambiguity
    assert enc[0, 3].sum() == 6
    assert enc[1, 2].sum() == 6
    # definite states one-hot
    assert enc[1, 3].tolist() == [0, 0, 0, 0, 0, 1]
    with pytest.raises(ValueError):
        datatypes.encode_generic(["0~"])


def test_codpos_restriction(tmp_path):
    """codpos=k keeps sites k-1, k+2, ... exactly (utilities.c:184)."""
    from phyml_tpu import LikelihoodEngine, SubstModel, read_alignment
    from phyml_tpu.ops.likelihood import tree_arrays
    from phyml_tpu.topology import Topology

    rng = np.random.default_rng(3)
    names = [f"t{i}" for i in range(6)]
    seqs = ["".join(rng.choice(list("ACGT"), 90)) for _ in names]
    full = tmp_path / "full.phy"
    _write_phylip(full, names, seqs)
    for codpos in (1, 2, 3):
        sub = tmp_path / f"sub{codpos}.phy"
        _write_phylip(sub, names, [s[codpos - 1::3] for s in seqs])
        a1 = read_alignment(str(full), datatype="nt", codpos=codpos)
        a2 = read_alignment(str(sub), datatype="nt")
        assert a1.n_sites == 30
        m = SubstModel(datatype="nt", name="HKY85", n_classes=4)
        topo = Topology.random(6, np.random.default_rng(7),
                               mean_blen=0.1)
        ta = tree_arrays(topo.rooted(), dtype=jnp.float64)
        e1 = LikelihoodEngine(a1, m, dtype=jnp.float64)
        e2 = LikelihoodEngine(a2, m, dtype=jnp.float64)
        l1 = float(e1.loglik(m.init_params(a1.obs_state_freqs), ta))
        l2 = float(e2.loglik(m.init_params(a2.obs_state_freqs), ta))
        assert abs(l1 - l2) < 1e-9


def test_aa_rate_file_customaa():
    """--aa_rate_file: a PAML matrix file behaves as the CUSTOMAA
    model; feeding the LG4X X1 matrix must differ from plain LG and
    run end to end."""
    from phyml_tpu import LikelihoodEngine, SubstModel, read_alignment
    from phyml_tpu.models.matrices import read_paml_matrix
    from phyml_tpu.ops.likelihood import tree_arrays
    from phyml_tpu.topology import Topology

    aln = read_alignment(os.path.join(EXAMPLES, "proteic"),
                         datatype="aa")
    S, pi = read_paml_matrix(
        os.path.join(EXAMPLES, "lg4x", "X1.mat"))
    m = SubstModel(datatype="aa", name="CUSTOMAA", n_classes=4,
                   freqs_mode="model", custom_aa=(S, pi))
    m_lg = SubstModel(datatype="aa", name="LG", n_classes=4,
                      freqs_mode="model")
    topo = Topology.random(aln.n_otu, np.random.default_rng(2),
                           mean_blen=0.1)
    ta = tree_arrays(topo.rooted(), dtype=jnp.float64)
    e = LikelihoodEngine(aln, m, dtype=jnp.float64)
    e_lg = LikelihoodEngine(aln, m_lg, dtype=jnp.float64)
    l = float(e.loglik(m.init_params(), ta))
    l_lg = float(e_lg.loglik(m_lg.init_params(), ta))
    assert np.isfinite(l) and abs(l - l_lg) > 1.0


def test_cli_generic_and_codpos(tmp_path):
    """End-to-end CLI: -d generic analysis and --codpos run."""
    rng = np.random.default_rng(11)
    names = [f"t{i}" for i in range(6)]
    seqs = ["".join(rng.choice(list("012345"), 60)) for _ in names]
    gen = tmp_path / "gen.phy"
    _write_phylip(gen, names, seqs)
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run(
        [sys.executable, "-m", "phyml_tpu.cli", "-i", str(gen),
         "-d", "generic", "-c", "1", "-o", "lr", "-b", "0",
         "--platform", "cpu", "--quiet", "--no_memory_check"],
        capture_output=True, text=True, cwd="/root/repo", env=env)
    assert r.returncode == 0, r.stderr[-2000:]
    assert os.path.exists(str(gen) + "_phyml_stats.txt")

    nt = tmp_path / "nt.phy"
    _write_phylip(nt, names,
                  ["".join(rng.choice(list("ACGT"), 90))
                   for _ in names])
    r = subprocess.run(
        [sys.executable, "-m", "phyml_tpu.cli", "-i", str(nt),
         "-d", "nt", "--codpos", "2", "-c", "1", "-o", "lr",
         "-b", "0", "--platform", "cpu", "--quiet",
         "--no_memory_check"],
        capture_output=True, text=True, cwd="/root/repo", env=env)
    assert r.returncode == 0, r.stderr[-2000:]
