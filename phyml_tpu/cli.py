"""Command-line front end, mirroring the reference's phyml CLI.

Reference: Read_Command_Line (cl.c:19) and the per-dataset driver
loop (main.c:108-434).  The option surface below covers the phyml
binary's analysis options; XML-driven analyses go through
`--xml` (xml.py).

Usage examples (same shapes as PhyML):
  phyml-tpu -i aln.phy -d nt -m GTR -c 4 -a e -b 0 -o tlr -s SPR
  phyml-tpu -i prot.phy -d aa -m LG -c 4 -v e -b 100
  phyml-tpu -i aln.phy -u tree.nwk -o lr --r_seed 42 -b -5
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="phyml-tpu",
        description="GPU phylogenetic ML (PhyML-compatible CLI)",
    )
    p.add_argument("-i", "--input", required=True,
                   help="PHYLIP/FASTA/NEXUS alignment")
    p.add_argument("-d", "--datatype",
                   choices=["nt", "aa", "generic", "gen"],
                   default=None)
    p.add_argument("-q", "--sequential", action="store_true",
                   help="sequential (non-interleaved) PHYLIP")
    p.add_argument("-n", "--multiple", type=int, default=1,
                   help="number of data sets (PHYLIP multi-alignment)")
    p.add_argument("-m", "--model", default=None,
                   help="JC69|K80|F81|HKY85|F84|TN93|GTR|custom string "
                        "| LG|WAG|JTT|...|LG4X (aa)")
    p.add_argument("-f", "--frequencies", default=None,
                   help="'e' empirical, 'm' model/ML, 'o' optimized, "
                        "or 'fA,fC,fG,fT'")
    p.add_argument("-t", "--ts_tv", default="e",
                   help="transition/transversion ratio (or 'e')")
    p.add_argument("-c", "--n_classes", "--nclasses", type=int,
                   default=4)
    # reference default: alpha FIXED at 1.0 unless `-a e`
    # (Init_Scalar_Dbl init.c:31 defaults optimize=NO; only kappa is
    #  estimated by default, Set_Defaults_Model init.c:688)
    p.add_argument("-a", "--alpha", default="1.0",
                   help="gamma shape (or 'e' to estimate)")
    p.add_argument("-v", "--pinv", default="0.0",
                   help="proportion of invariant sites (or 'e')")
    p.add_argument("--free_rates", "--freerates", "--freerate",
                   action="store_true",
                   help="FreeRate model instead of discrete gamma")
    p.add_argument("--codpos", type=int, default=None,
                   help="analyse only this codon position (1|2|3); "
                        "reference cl.c:412-428")
    p.add_argument("--aa_rate_file", default=None,
                   help="PAML-format custom AA rate matrix "
                        "(CUSTOMAA, reference cl.c:560-570)")
    p.add_argument("--il", action="store_true",
                   help="integrated-length model: each branch length "
                        "Gamma-distributed with variance blen*sigma, "
                        "sigma estimated (reference --il / "
                        "gamma_mgf_bl; Guindon 2012)")
    p.add_argument("-u", "--user_tree", "--inputtree",
                   default=None,
                   help="starting tree newick file")
    p.add_argument("-o", "--optimize", default="tlr",
                   help="t=topology l=lengths r=rates; 'n' = none")
    p.add_argument("-s", "--search", choices=["NNI", "SPR", "BEST"],
                   default="NNI")
    p.add_argument("-b", "--bootstrap", type=int, default=0,
                   help=">0: replicates; 0: none; -1: aLRT stat; "
                        "-2: aLRT chi2; -4: SH-aLRT; -5: aBayes")
    p.add_argument("--tbe", action="store_true",
                   help="transfer bootstrap (TBE) instead of FBP")
    p.add_argument("--bayesian_bootstrap", action="store_true",
                   help="Dirichlet-weight bootstrap")
    p.add_argument("--rapid_boot", action="store_true",
                   help="device-batched bootstrap: all replicates' "
                        "branch lengths + NNI rounds advance in one "
                        "dispatch per round, model parameters frozen "
                        "at the ML estimates (supports differ "
                        "slightly from full re-estimation)")
    p.add_argument("--r_seed", type=int, default=None)
    p.add_argument("--rand_start", action="store_true",
                   help="random starting tree(s); the search is run "
                        "from --n_rand_starts of them and the best "
                        "final tree is kept (main.c:126-139)")
    p.add_argument("--n_rand_starts", type=int, default=5)
    p.add_argument("--pars_start", action="store_true",
                   help="stepwise-addition parsimony starting tree "
                        "(Stepwise_Add_Pars pars.c:948) instead of "
                        "BioNJ")
    p.add_argument("--constraint_file", default=None,
                   help="multifurcating constraint tree; the search "
                        "starts from a random binary resolution and "
                        "only considers compatible topologies")
    p.add_argument("--platform", choices=["cpu", "gpu"], default=None,
                   help="run on this JAX backend; gpu fails where JAX "
                        "finds no GPU.  Default: JAX's choice.  The "
                        "engine runs float32 on a GPU, float64 on the "
                        "CPU")
    p.add_argument("--distributed", action="store_true",
                   help="multi-process run via jax.distributed, one "
                        "process per GPU: bootstrap replicates are "
                        "farmed round-robin over processes, counts "
                        "reduced globally (the phyml-mpi equivalent)")
    p.add_argument("--coordinator_address", default=None,
                   help="with --distributed: host:port of process 0")
    p.add_argument("--num_processes", type=int, default=None,
                   help="with --distributed: number of processes")
    p.add_argument("--process_id", type=int, default=None,
                   help="with --distributed: this process's id")
    p.add_argument("--weights", default=None,
                   help="site-weight file")
    # covarion (M4) family; the reference's --cov CLI (cl.c:69-74) is
    # bit-rotted upstream (see tests/test_covarion.py docstring) but
    # the option surface is preserved here
    p.add_argument("--cov", action="store_true",
                   help="covarion (M4) model: hidden rate classes "
                        "with switching")
    p.add_argument("--cov_delta", default=None,
                   help="switching rate (value, or 'e' to estimate)")
    p.add_argument("--cov_alpha", default=None,
                   help="gamma shape of hidden-class rates (value or "
                        "'e'); selects the --cov_alpha mode")
    p.add_argument("--cov_ncats", type=int, default=3,
                   help="number of hidden rate classes")
    p.add_argument("--cov_free", action="store_true",
                   help="free hidden-class rates and frequencies")
    p.add_argument("--cv", choices=["tip", "kfold.col", "kfold.pos"],
                   default=None,
                   help="cross-validation for model selection "
                        "(reference cv.c / XML cv.type); writes "
                        "_phyml_cv.txt")
    p.add_argument("--ancestral", "--anc", action="store_true",
                   help="marginal ancestral state reconstruction "
                        "(writes _phyml_ancestral_seq.txt + tree)")
    p.add_argument("--ps", action="store_true",
                   help="write a PostScript phylogram "
                        "(_phyml_tree.ps; reference draw.c)")
    p.add_argument("--print_site_lnl", "--print_site_lk",
                   action="store_true")
    p.add_argument("--print_trace", action="store_true",
                   help="append a newick line to _phyml_trace.txt at "
                        "every search improvement (io.c fp_out_trace)")
    p.add_argument("--json_trace", action="store_true",
                   help="JSON snapshots of tree+lnL per improvement "
                        "(_phyml_trace.json; JSON_Tree_Io io.c:6737)")
    p.add_argument("--min_diff_lk_global", type=float, default=None,
                   help="convergence window of the topology search "
                        "(cl.c case 17)")
    p.add_argument("--no_five_branch", action="store_true",
                   help="skip the closing five-branch NNI polish of "
                        "the SPR search (cl.c case 41)")
    p.add_argument("--alias_subpatt", action="store_true",
                   help="report subtree-pattern aliasing statistics "
                        "(utilities.c:13528 Alias_Subpatt; the engine "
                        "exploits pattern compression automatically)")
    p.add_argument("--mutmap", action="store_true",
                   help="sample one substitution history on the final "
                        "tree and write _phyml_mutmap.txt "
                        "(ancestral.c:345 Map_Mutations)")
    p.add_argument("--no_gap", action="store_true",
                   help="remove columns containing gaps or ambiguous "
                        "characters (cl.c case 38)")
    p.add_argument("--append", action="store_true",
                   help="append to existing output files instead of "
                        "overwriting (cl.c case 40)")
    p.add_argument("--leave_duplicates", action="store_true")
    p.add_argument("--no_memory_check", action="store_true")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--run_id", default=None)
    p.add_argument("--xml", default=None,
                   help="XML analysis description (partitions/mixtures)")
    p.add_argument("--datatype_guess", action="store_true")
    p.add_argument("--float32", action="store_true",
                   help="fp32 likelihood (default on GPU; fp64 on CPU)")
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint file; resumes if it exists")
    p.add_argument("--checkpoint_every", type=int, default=300,
                   help="checkpoint interval, seconds")
    return p


def _build_model(args, aln):
    from phyml_tpu.models.substitution import SubstModel, lg4x_model

    name = args.model
    if aln.datatype == "generic":
        # custom alphabet: JC over the inferred state count
        # (cl.c:929-932, init.c:1519-1533)
        return SubstModel(
            datatype="generic",
            generic_ns=int(aln.partials.shape[-1]),
            n_classes=args.n_classes,
            invar=(args.pinv == "e" or float(args.pinv or 0) > 0),
            optimize_alpha="r" in args.optimize and args.alpha == "e",
            optimize_pinv="r" in args.optimize and args.pinv == "e",
        )
    if name is None:
        name = "HKY85" if aln.datatype == "nt" else "LG"
    if name.upper() == "LG4X":
        model = lg4x_model()
        return model
    freqs_mode = None
    fixed = None
    if args.frequencies:
        f = args.frequencies
        if f == "e":
            freqs_mode = "empirical"
        elif f == "m":
            freqs_mode = "model" if aln.datatype == "aa" else "optimize"
        elif f == "o":
            freqs_mode = "optimize"
        else:
            fixed = np.asarray([float(x) for x in f.split(",")])
            freqs_mode = "fixed"
    opt_r = "r" in args.optimize
    use_cov = (args.cov or args.cov_free or args.cov_delta is not None
               or args.cov_alpha is not None)
    cov_mode = "fixed"
    if args.cov_free:
        cov_mode = "free"
    elif args.cov_alpha is not None:
        cov_mode = "alpha"
    custom_aa = None
    if getattr(args, "aa_rate_file", None):
        from phyml_tpu.models.matrices import read_paml_matrix
        custom_aa = read_paml_matrix(args.aa_rate_file)
        name = "CUSTOMAA"
    model = SubstModel(
        datatype=aln.datatype,
        name=name,
        custom_aa=custom_aa,
        n_classes=args.n_classes,
        invar=(args.pinv == "e" or float(args.pinv or 0) > 0),
        freerate=args.free_rates,
        freqs_mode=freqs_mode,
        fixed_freqs=fixed,
        covarion=use_cov,
        n_hidden=args.cov_ncats,
        cov_mode=cov_mode,
        optimize_kappa=opt_r and args.ts_tv == "e",
        optimize_alpha=opt_r and args.alpha == "e",
        optimize_pinv=opt_r and args.pinv == "e",
        optimize_rr=opt_r,
        optimize_cov=opt_r and (args.cov_delta == "e"
                                or args.cov_alpha == "e"
                                or args.cov_free),
    )
    return model


def _init_params(args, model, aln):
    import jax.numpy as jnp

    params = model.init_params(aln.obs_state_freqs)
    if args.ts_tv != "e" and "kappa" in params:
        params["kappa"] = jnp.asarray(float(args.ts_tv))
    if args.alpha != "e" and "alpha" in params:
        params["alpha"] = jnp.asarray(float(args.alpha))
    if args.pinv != "e" and model.invar:
        params["pinv"] = jnp.asarray(float(args.pinv))
    if model.covarion:
        if args.cov_delta not in (None, "e"):
            params["cov_delta"] = jnp.asarray(float(args.cov_delta))
        if args.cov_alpha not in (None, "e") and "cov_alpha" in params:
            params["cov_alpha"] = jnp.asarray(float(args.cov_alpha))
    if getattr(args, "il", False):
        # IL branch-length variance sigma, stored in log space and
        # optimized with the other scalars (reference default 0.1,
        # init.c:693); the engine substitutes the MGF eigenvalues in
        # _system, so every search/optimizer path is exact under IL
        params["il_sigma"] = jnp.asarray(float(np.log(0.1)))
    return params


def run_analysis(args) -> int:
    from phyml_tpu.platform import enable_compile_cache, select_platform

    enable_compile_cache()
    if args.distributed:
        # before the first device use: jax.distributed must see the
        # backend uninitialized
        from phyml_tpu.parallel.boot import initialize_distributed
        pid, nproc = initialize_distributed(
            coordinator_address=args.coordinator_address,
            num_processes=args.num_processes,
            process_id=args.process_id)
        if pid != 0:
            args.quiet = True
        if not args.quiet:
            print(f". Distributed run: process {pid} of {nproc}.")
    args.dtype = select_platform(args.platform, args.float32)

    from phyml_tpu.io.alignment import (
        read_alignment, read_alignments_multi, read_site_weights,
    )

    seed = args.r_seed if args.r_seed is not None else int(
        time.time()) % (2 ** 31)
    rng = np.random.default_rng(seed)
    site_w = read_site_weights(args.weights) if args.weights else None

    if args.datatype == "gen":
        args.datatype = "generic"
    if args.multiple > 1:
        alns = read_alignments_multi(
            args.input, args.multiple, datatype=args.datatype,
            interleaved=not args.sequential, site_weights=site_w)
    else:
        alns = [read_alignment(args.input, datatype=args.datatype,
                               interleaved=not args.sequential,
                               site_weights=site_w,
                               codpos=args.codpos)]
    if args.no_gap:
        from phyml_tpu.io.alignment import remove_ambiguous_patterns
        alns = [remove_ambiguous_patterns(a) for a in alns]
    rc = 0
    for set_idx, aln in enumerate(alns):
        if len(alns) > 1 and not args.quiet:
            print(f"\n. Data set #{set_idx + 1} of {len(alns)}.")
        rc |= _run_dataset(args, aln, rng, seed, set_idx, len(alns))
    return rc


def _run_dataset(args, aln, rng, seed, set_idx=0, n_sets=1) -> int:
    import jax
    import jax.numpy as jnp

    from phyml_tpu.io.output import (
        format_stats, write_results, write_site_lnl,
    )
    from phyml_tpu.ops.likelihood import LikelihoodEngine, tree_arrays
    from phyml_tpu.optim.round import round_optimize
    from phyml_tpu.search.bionj import bionj_start
    from phyml_tpu.search.driver import nni_search, spr_search
    from phyml_tpu.search.support import (
        alrt_supports, bootstrap_supports,
    )
    from phyml_tpu.topology import Topology
    from phyml_tpu.ops.parsimony import parsimony_score

    t_start = time.time()

    # duplicate-sequence removal (Remove_Duplicates utilities.c:2675;
    # re-inserted in the output tree as in main.c:389)
    dup_name_pairs: list[tuple[str, str]] = []
    dup_indices: list[int] = []
    orig_names = list(aln.names)
    if not args.leave_duplicates and aln.n_otu >= 4:
        from phyml_tpu.io.alignment import drop_taxa, find_duplicate_taxa
        pairs = find_duplicate_taxa(aln)
        if pairs and aln.n_otu - len(pairs) >= 4:
            for d, k in pairs:
                if not args.quiet:
                    print(f". Note: taxon '{aln.names[d]}' is a "
                          f"duplicate of taxon '{aln.names[k]}'.")
                dup_name_pairs.append((aln.names[d], aln.names[k]))
            dup_indices = [d for d, _ in pairs]
            aln = drop_taxa(aln, dup_indices)

    if not args.quiet:
        print(f". {aln.n_patterns} patterns found (out of a total of "
              f"{aln.n_sites} sites).")

    model = _build_model(args, aln)
    params = _init_params(args, model, aln)

    dtype = args.dtype
    engine = LikelihoodEngine(aln, model, dtype=dtype)

    # ---- topological constraint (reference --constraint_file) ---------
    constraint = None
    accept_topo = None
    if args.constraint_file:
        from phyml_tpu.search.constraint import Constraint
        constraint = Constraint.from_file(args.constraint_file,
                                          aln.names)
        accept_topo = constraint.is_compatible

    # ---- starting tree ------------------------------------------------
    if args.user_tree:
        with open(args.user_tree) as fh:
            user_nwk = fh.read()
        if dup_indices:
            topo = Topology.from_newick(user_nwk, orig_names) \
                .without_leaves(set(dup_indices))
        else:
            topo = Topology.from_newick(user_nwk, aln.names)
        if constraint is not None and not constraint.is_compatible(topo):
            print("!! the user tree violates the constraint tree",
                  file=sys.stderr)
            return 1
        start_desc = f"user tree ({args.user_tree})"
    elif constraint is not None:
        topo = constraint.random_resolution(rng)
        start_desc = f"constraint resolution ({args.constraint_file})"
    elif args.rand_start:
        topo = Topology.random(aln.n_otu, rng)
        start_desc = "random"
    elif args.pars_start:
        from phyml_tpu.search.stepwise import stepwise_addition_tree
        topo = stepwise_addition_tree(aln, rng)
        start_desc = "stepwise-addition parsimony"
    else:
        topo = bionj_start(engine, params)
        start_desc = "BioNJ"

    # ---- optimize -----------------------------------------------------
    opt = args.optimize
    opt_topo = "t" in opt
    opt_len = "l" in opt or opt_topo
    opt_rates = "r" in opt

    checkpointer = None
    if args.checkpoint:
        from phyml_tpu.utils.checkpoint import Checkpointer
        checkpointer = Checkpointer(args.checkpoint,
                                    every_s=args.checkpoint_every)
        resumed = checkpointer.resume()
        if resumed is not None:
            topo, params, stage = resumed
            if not args.quiet:
                print(f". Resumed from checkpoint ({stage}).")

    trace = None
    if args.print_trace or args.json_trace:
        from phyml_tpu.io.output import TraceWriter
        run_id_ = f"_{args.run_id}" if args.run_id else ""
        trace_prefix = f"{args.input}{run_id_}"
        if n_sets > 1:
            trace_prefix += f"_set{set_idx + 1}"
        trace = TraceWriter(
            aln.names,
            newick_path=(f"{trace_prefix}_phyml_trace.txt"
                         if args.print_trace else None),
            json_path=(f"{trace_prefix}_phyml_trace.json"
                       if args.json_trace else None),
        )

    if opt_topo:
        # -s BEST runs BOTH strategies and keeps the better tree
        # (cl.c: "BEST: best of NNI and SPR search"); --rand_start
        # repeats the search from --n_rand_starts random starting
        # trees and keeps the best final lnL (main.c:126-139, 308-312)
        kinds = ["NNI", "SPR"] if args.search == "BEST" \
            else [args.search]
        search_desc = args.search
        if args.rand_start:
            starts = []
            for _ in range(max(1, args.n_rand_starts)):
                starts.append(
                    constraint.random_resolution(rng)
                    if constraint is not None
                    else Topology.random(aln.n_otu, rng))
        else:
            starts = [topo]

        def _one(topo0, kind, params0):
            from phyml_tpu.search.driver import ml_search
            return ml_search(
                engine, model, params0, topo0,
                kind=kind.lower(), retries=2, opt_params=opt_rates,
                seed=seed, verbose=not args.quiet, trace=trace,
                accept_topo=accept_topo,
                tol=args.min_diff_lk_global,
                five_branch=not args.no_five_branch)

        best = None
        for si, topo0 in enumerate(starts):
            for kind in kinds:
                if not args.quiet and (len(starts) > 1
                                       or len(kinds) > 1):
                    print(f". Search {kind}, start "
                          f"{si + 1}/{len(starts)}:")
                cand = _one(topo0.copy(), kind, dict(params))
                if best is None or cand[2] > best[2]:
                    best = cand
        topo, params, lnl = best
    else:
        search_desc = "none"
        ta = tree_arrays(topo.rooted(), dtype=dtype)
        if opt_len or opt_rates:
            params, ta, lnl = round_optimize(
                engine, model, params, ta,
                opt_blen=opt_len, opt_params=opt_rates,
            )
        else:
            lnl = float(engine.loglik(params, ta))
        rv = topo.rooted()
        topo.set_blen_from_rooted(rv, np.asarray(ta.blen))

    if checkpointer is not None:
        checkpointer.save(topo, params, "search_done", force=True)

    # ---- branch support ----------------------------------------------
    support = None
    b = args.bootstrap
    if b > 0:
        boot_search = "spr" if args.search in ("SPR", "BEST") else "nni"
        if args.distributed and jax.process_count() > 1:
            from phyml_tpu.parallel.boot import (
                run_bootstrap_distributed, share_from_process0,
            )
            topo, params = share_from_process0(topo, params)
            support = run_bootstrap_distributed(
                engine, model, params, topo, n_replicates=b,
                search=boot_search, seed=seed,
                bayesian=args.bayesian_bootstrap, tbe=args.tbe,
                verbose=not args.quiet,
            )
        elif args.rapid_boot:
            from phyml_tpu.search.support import (
                bootstrap_supports_batched,
            )
            support = bootstrap_supports_batched(
                engine, model, params, topo, n_replicates=b,
                seed=seed, bayesian=args.bayesian_bootstrap,
                tbe=args.tbe, verbose=not args.quiet,
            )
        else:
            support = bootstrap_supports(
                engine, model, params, topo, n_replicates=b,
                search=boot_search,
                seed=seed, bayesian=args.bayesian_bootstrap,
                tbe=args.tbe, verbose=not args.quiet,
            )
        support_fmt = "%.0f"
        support = {eid: v * b for eid, v in support.items()}
    elif b < 0:
        method = {-1: "alrt-stat", -2: "alrt-chi2", -3: "alrt-chi2",
                  -4: "sh", -5: "abayes"}[b]
        support = alrt_supports(engine, model, params, topo,
                                method=method, seed=seed)
        support_fmt = "%.6f" if b == -1 else "%.4f"
    else:
        support_fmt = "%.2f"

    # ---- outputs ------------------------------------------------------
    if args.distributed and jax.process_index() != 0:
        # rank-0-writes pattern (mpi_boot.c:282-314); all processes
        # participated in the count reduction above
        return 0
    pars = parsimony_score(engine, topo)
    il_lines = []
    if "il_sigma" in params:
        il_lines = [
            ". Integrated length (IL) model: \tyes",
            f"  - IL variance parameter sigma: \t"
            f"{float(np.exp(params['il_sigma'])):.5f}",
        ]
    stats = format_stats(
        input_name=args.input, aln=aln, model=model, params=params,
        lnl=lnl, topo=topo, search_desc=search_desc,
        start_tree_desc=start_desc, runtime_s=time.time() - t_start,
        seed=seed, n_parsimony=pars, extra_lines=il_lines,
    )
    run_id = f"_{args.run_id}" if args.run_id else ""
    prefix = f"{args.input}{run_id}"
    tree_path, stats_path = write_results(
        prefix, topo, aln.names, stats,
        support=support, support_fmt=support_fmt,
        append=(set_idx > 0 or args.append),
    )
    if n_sets > 1:
        # aux outputs below must not clobber across data sets
        prefix = f"{prefix}_set{set_idx + 1}"
    if dup_name_pairs:
        from phyml_tpu.io.newick import insert_duplicate_leaves
        with open(tree_path) as fh:
            full = insert_duplicate_leaves(fh.read(), dup_name_pairs)
        with open(tree_path, "w") as fh:
            fh.write(full + "\n")
    if args.print_site_lnl:
        ta = tree_arrays(topo.rooted(), dtype=dtype)
        write_site_lnl(f"{prefix}_phyml_lk.txt", aln,
                       engine.site_logliks(params, ta))
    if args.ps:
        from phyml_tpu.io.draw import write_postscript
        write_postscript(f"{prefix}_phyml_tree.ps", topo, aln.names,
                         title=args.input)
    if args.cv:
        from phyml_tpu.io.output import write_cv
        from phyml_tpu.ops import crossval
        ta = tree_arrays(topo.rooted(), dtype=dtype)
        if args.cv == "tip":
            res = crossval.tip_cv(engine, params, ta)
            write_cv(f"{prefix}_phyml_cv.txt", aln, model, "tip", res)
            if not args.quiet:
                print(f". CV score (mean log predictive prob): "
                      f"{res['score']:.6f}")
        elif args.cv == "kfold.col":
            total, folds = crossval.kfold_col_cv(
                engine, model, params, ta, rng=rng,
                verbose=not args.quiet,
            )
            write_cv(f"{prefix}_phyml_cv.txt", aln, model,
                     "kfold.col", dict(score=total, folds=folds))
            if not args.quiet:
                print(f". CV held-out log-likelihood: {total:.4f}")
        else:
            def factory(a):
                return LikelihoodEngine(a, model, dtype=dtype)
            score, n_masked = crossval.kfold_pos_cv(
                factory, aln, model, params, ta, rng=rng)
            write_cv(f"{prefix}_phyml_cv.txt", aln, model,
                     "kfold.pos", dict(score=score, n_masked=n_masked))
            if not args.quiet:
                print(f". CV score at {n_masked} masked cells: "
                      f"{score:.4f}")
    if args.ancestral:
        from phyml_tpu.io.output import write_ancestral
        from phyml_tpu.ops.ancestral import marginal_posteriors
        rv = topo.rooted()
        ta = tree_arrays(rv, dtype=dtype)
        probs = marginal_posteriors(engine, params, ta)
        write_ancestral(prefix, aln, topo, rv, probs, aln.datatype)
    if args.mutmap:
        # one joint draw of (rate classes, ancestral states) then
        # endpoint-conditioned path sampling per (edge, site)
        # (Sample_Ancestral_Seq ancestral.c:15 + Map_Mutations :345)
        from phyml_tpu.ops.ancestral import (
            map_mutations, sample_ancestral,
        )
        ta = tree_arrays(topo.rooted(), dtype=dtype)
        classes, states = sample_ancestral(
            engine, params, ta, jax.random.PRNGKey(seed))
        events = map_mutations(engine, params, ta,
                               np.asarray(classes), np.asarray(states),
                               np.random.default_rng(seed + 31))
        with open(f"{prefix}_phyml_mutmap.txt", "w") as fh:
            fh.write("# sampled substitution history "
                     "(node, site, time_from_parent, from, to)\n")
            for (u, pp, t, s_from, s_to) in events:
                fh.write(f"{u}\t{pp}\t{t:.6g}\t{s_from}\t{s_to}\n")
        if not args.quiet:
            print(f". Mutation map written to "
                  f"{prefix}_phyml_mutmap.txt")
    if args.alias_subpatt:
        from phyml_tpu.ops.alias import alias_stats
        rep = alias_stats(aln, np.asarray(topo.rooted().child))
        if not args.quiet:
            print(f". Subpattern aliasing: {rep}")
    if not args.quiet:
        print(f". Log-likelihood: {lnl:.5f}")
        print(f". Results written to {tree_path} and {stats_path}")
    return 0


def main(argv=None) -> int:
    real_argv = sys.argv[1:] if argv is None else argv
    if not real_argv:
        # no options: drop into the PHYLIP-style menu, exactly like
        # the reference (Get_Input io.c:4373-4384 -> interface.c:15)
        from phyml_tpu.interface import launch_interface
        return launch_interface()
    args = build_parser().parse_args(argv)
    if args.xml:
        from phyml_tpu.io.xmlcfg import run_xml
        from phyml_tpu.platform import enable_compile_cache
        enable_compile_cache()
        return run_xml(args.xml, quiet=args.quiet,
                       platform=args.platform, float32=args.float32)
    return run_analysis(args)


if __name__ == "__main__":
    sys.exit(main())
