"""Command-line entry point of the port: every analysis and every flag of
``wgsassign_tpu.cli``, on one GPU or on several ranks (one process per GPU,
the site axis in windows; see :func:`main`).

Takes the reference's flags (``parser`` below, a copy of the argparse
parser of ``wgsassign_tpu.cli``), runs its sections in the same order --
reference AF, ``--ne_obs``, ``--loo``; ``--get_pop_like``; the z-scores; the
mixture -- and writes the same files through
``wgsassign_tpu_torch.io.writers``: ``.args``,
``.pop_af.npy``, ``.pop_names.txt``, ``.fisher_obs.npy``, ``.ne_obs.npy``,
``.ne_obs.txt``, ``.ne_ind.txt``, ``.pop_like_LOO[_downsampled].tsv`` and,
with ``--partition_sites``, the partition ``.tsv.gz``; ``.pop_like.txt``;
``.reference_z_ind.txt`` and ``.z_ind.txt``; ``.em_mix.txt`` and
``.mcmc_mix.txt``.  ``--stream_ingest`` streams the Beagle file to the
device in site blocks; ``--debug_checks`` sanitises the likelihood inputs
(there is no counterpart of ``jax_debug_nans``); ``--profile DIR`` writes a
``torch.profiler`` trace.  ``--no_pallas`` runs the plain EM ops instead of
the kernels; ``--use_pallas`` asks for what is the default already (the
kernels on a GPU, their twins through the chunked EM on the CPU).  No
flag is ignored.

Runs on ``cuda:0`` unless :func:`main` is given another ``device``; without
CUDA it raises.  ``device="cpu"`` (a Python argument, not a flag) runs the
kernels' plain PyTorch twins, for tests.
"""

from __future__ import annotations

import argparse
import os
import sys

from wgsassign_tpu_torch.version import __version__

# The flags, defaults and help strings of wgsassign_tpu/cli.py, copied: the
# two command lines and their ``.args`` logs stay interchangeable.
parser = argparse.ArgumentParser(prog="WGSassign")
parser.add_argument("-b", "--beagle", metavar="FILE",
    help="Filepath to genotype likelihoods in gzipped Beagle format from ANGSD")
parser.add_argument("-t", "--threads", metavar="INT", type=int, default=0,
    help="Number of host threads for the Beagle parser (default 0 = all "
         "cores); device parallelism uses the mesh")
parser.add_argument("-o", "--out", metavar="OUTPUT", default="wgsassign",
    help="Prefix for output files")
parser.add_argument("--maf_iter", metavar="INT", type=int, default=200,
    help="Maximum iterations for minor allele frequencies estimation - EM (200)")
parser.add_argument("--maf_tole", metavar="FLOAT", type=float, default=1e-4,
    help="Tolerance for minor allele frequencies estimation update - EM (1e-4)")

# Reference population allele frequencies
parser.add_argument("--pop_af_IDs", metavar="FILE",
    help="Filepath to individual IDs and populations for beagle")
parser.add_argument("--get_reference_af", action="store_true",
    help="Estimate allele frequencies for reference populations")
parser.add_argument("--pop_names", metavar="FILE",
    help="Filepath to population names of allele frequency file")

# Effective sample size / Fisher info
parser.add_argument("--ne_obs", action="store_true",
    help="Estimate population and individuals effective sample sizes")

# Leave-one-out
parser.add_argument("--loo", action="store_true",
    help="Perform leave-one-out cross validation")
parser.add_argument("--loo_downsampled_beagle", metavar="FILE",
    help="Optional Beagle file of downsampled genotype likelihoods to use for "
         "LOO assignment")

# Assignment likelihoods
parser.add_argument("--pop_af_file", metavar="FILE",
    help="Filepath to reference population allele frequencies")
parser.add_argument("--get_pop_like", action="store_true",
    help="Estimate log likelihood of individual assignment to each reference population")
parser.add_argument("--partition_sites", type=int, metavar="INT", default=1,
    help="Optional: partition sites into INT subsets (by modulo) and report "
         "assignment log-likelihoods for each subset")

# Z-score
parser.add_argument("--get_assignment_z_score", action="store_true",
    help="Calculate z-score for individuals (assigned-population AF mode)")
parser.add_argument("--get_reference_z_score", action="store_true",
    help="Calculate z-score for individuals (own-population LOO AF mode)")
parser.add_argument("--ind_ad_file", metavar="FILE",
    help="Filepath to individual allele depths, tab-delimited, .txt or .gz")
parser.add_argument("--allele_count_threshold", metavar="INT", type=int,
    help="Minimum number of loci needed to keep a specific allele count combination")
parser.add_argument("--single_read_threshold", action="store_true",
    help="Use only loci with a single read")
parser.add_argument("--ind_start", metavar="INT", type=int,
    help="Start analysis at this individual index (0-indexed)")
parser.add_argument("--ind_end", metavar="INT", type=int,
    help="End analysis at this individual index (exclusive upper bound)")
parser.add_argument("--zscore_error_rate", metavar="FLOAT", type=float,
    default=0.01,
    help="Sequencing error rate for the z-score read-probability tables "
         "(the reference hard-codes 0.01, WGSassign.py:350,430)")

# Mixture proportions
parser.add_argument("--pop_like", metavar="FILE",
    help="Filepath to population assignment log likelihood file")
parser.add_argument("--pop_like_IDs", metavar="FILE",
    help="Filepath to IDs for population assignment log likelihood file")
parser.add_argument("--get_em_mix", action="store_true",
    help="Estimate mixture proportions with EM algorithm")
parser.add_argument("--get_mcmc_mix", action="store_true",
    help="Estimate mixture proportions with MCMC algorithm")
parser.add_argument("--mixture_iter", metavar="INT", type=int, default=200,
    help="Maximum iterations mixture estimation - EM (200)")

# Engine options (not in the reference)
parser.add_argument("--devices", metavar="INT", type=int, default=None,
    help="Use only the first INT devices of the mesh (default: all)")
parser.add_argument("--use_pallas", action="store_true",
    help="Force the fused Pallas kernels on")
parser.add_argument("--fast_em", action="store_true",
    help="(default, kept for compatibility) Algebraically-reduced EM "
         "update in the fused kernels (~1.2x measured on v5e); "
         "bit-identical to the canonical op order for normal-range "
         "operands (empirically verified)")
parser.add_argument("--no_fast_em", action="store_true",
    help="Use the canonical (textbook) EM op order in the fused kernels — "
         "a debugging kill switch; the two forms are bit-identical for "
         "normal-range operands")
parser.add_argument("--no_pallas", action="store_true",
    help="Force the fused Pallas kernels off (pure-XLA path)")
parser.add_argument("--profile", metavar="DIR",
    help="Write a jax profiler trace of the run to DIR")
parser.add_argument("--stable_mix", action="store_true",
    help="Log-sum-exp mixture EM (immune to exp underflow)")
parser.add_argument("--loo_clean_af", action="store_true",
    help="LOO: evaluate foreign populations with full-data AF instead of "
         "reproducing the reference's in-place mutation order dependence")
parser.add_argument("--mcmc_seed", metavar="INT", type=int, default=None,
    help="Random seed for --get_mcmc_mix")
parser.add_argument("--mcmc_last_draw", action="store_true",
    help="MCMC: report the last draw instead of the posterior mean")
parser.add_argument("--f32_sums", action="store_true",
    help="Accumulate site-axis log-likelihood sums in float32 (single fused "
         "reduction) instead of the reference-matching blocked-f64 scheme")
parser.add_argument("--stream_ingest", metavar="ROWS", type=int, default=None,
    help="Stream the Beagle file to device in site blocks of ROWS rows "
         "(0 = auto-size ~256 MiB blocks) instead of materializing the full "
         "GL matrix on host — M is then bounded by device HBM, not host RAM. "
         "Works with every analysis: z-scores gather per-individual GL "
         "columns back from the device cohort, and the downsampled-LOO "
         "site intersection streams through a site-name scan pass. "
         "Composes with multi-host runs: each process streams only its own "
         "row window into its local devices")
parser.add_argument("--em_checkpoint", action="store_true",
    help="Periodically checkpoint EM state next to the output prefix and "
         "resume from it (fused-kernel path)")
parser.add_argument("--debug_checks", action="store_true",
    help="Enable NaN debugging (jax_debug_nans) plus checkify sanitizers "
         "on the likelihood paths (catches malformed GL triples that would "
         "silently produce -inf log-likelihoods)")
parser.add_argument("--log_level", metavar="LEVEL", default=None,
    help="Structured-log level for the wgsassign_tpu logger (default WARNING; "
         "also via WGSA_LOG_LEVEL)")


def main(argv=None, device=None):
    """Run the CLI.  ``device`` defaults to ``cuda:0`` and must be given as
    ``"cpu"`` explicitly to run without a GPU.

    Several ranks, one process per device, each with a window of the site
    axis: ``--devices n`` starts ``n`` ranks on this host and waits for
    them; under ``WGSA_COORDINATOR_ADDRESS``, ``WGSA_NUM_PROCESSES`` and
    ``WGSA_PROCESS_ID`` (the JAX package's variables) this process is one
    rank of a run that something else started.  Without either, one rank
    runs on ``cuda:0`` whatever the host has (the JAX package takes every
    device by default).  Returns the run's
    :class:`RunTimer` (None from the parent of ``--devices n`` ranks)."""
    args = parser.parse_args(argv)
    n_args = len(sys.argv) - 1 if argv is None else len(argv)
    if n_args < 1:
        parser.print_help()
        sys.exit()
    if args.loo_downsampled_beagle and not args.loo:
        raise ValueError(
            "The --loo_downsampled_beagle option requires that --loo is also specified."
        )
    if args.use_pallas and args.no_pallas:
        raise ValueError("--use_pallas and --no_pallas are mutually exclusive")

    from wgsassign_tpu_torch.obs.log import setup_logging
    from wgsassign_tpu_torch.parallel.runtime import distributed_env

    setup_logging(args.log_level)
    device = "cuda:0" if device is None else str(device)
    if args.devices is not None:
        if distributed_env() is not None:
            raise ValueError(
                "--devices cannot be combined with a multi-host run (the "
                "mesh must span every process's devices)"
            )
        n_ranks = _local_ranks(args.devices, device)
        if n_ranks > 1:
            run_on_local_ranks(
                sys.argv[1:] if argv is None else list(argv), device, n_ranks)
            return None
    return _run(args, device, None)


def _local_ranks(asked: int, device: str) -> int:
    """``--devices n`` on this host: the first ``n`` cards, so more than
    the host has gives the host's count (as the JAX package's
    ``devices[:n]``), with a logged warning.  CPU ranks have no such
    count."""
    import torch

    from wgsassign_tpu_torch.parallel.runtime import log

    if asked < 1:
        raise ValueError("--devices needs a positive count")
    if not device.startswith("cuda"):
        return asked
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' explicitly to run the plain versions")
    have = torch.cuda.device_count()
    if asked > have:
        log.warning("--devices %d: this host has %d GPU(s); running %d "
                    "rank(s)", asked, have, have)
    return min(asked, have)


def _rank_entry(rank, world, address, argv, device):
    """Entry point of one ``--devices`` rank (a spawned process)."""
    _run(parser.parse_args(argv), device, (address, world, rank))


def run_on_local_ranks(argv, device, world):
    """Run ``world`` ranks of this command on this host (see
    :func:`wgsassign_tpu_torch.parallel.runtime.run_local_ranks`)."""
    from wgsassign_tpu_torch.parallel.runtime import run_local_ranks

    run_local_ranks(_rank_entry, world, argv, device,
                    what=f"--devices {world}")


def _run(args, device, ranks):
    """One rank's run: the only rank, or rank ``ranks[2]`` of ``ranks[1]``
    at the address ``ranks[0]`` (None: read the ``WGSA_*`` variables)."""
    import torch

    from wgsassign_tpu_torch.compile_cache import build_base
    from wgsassign_tpu_torch.io import writers
    from wgsassign_tpu_torch.obs.log import setup_logging
    from wgsassign_tpu_torch.obs.profiling import RunTimer
    from wgsassign_tpu_torch.obs.profiling import maybe_profile
    from wgsassign_tpu_torch.parallel.runtime import (
        log,
        make_runtime,
        shutdown_distributed,
    )

    setup_logging(args.log_level)  # a spawned rank starts unconfigured
    log.info("native builds (CUDA kernels, Beagle reader) under %s",
             build_base())
    runtime = make_runtime(device, fast_math=not args.no_fast_em,
                           debug_checks=args.debug_checks,
                           use_kernels=not args.no_pallas, ranks=ranks)
    stdout = sys.stdout
    devnull = None
    if not runtime.is_primary():
        # one rank owns stdout (the writers are guarded by ``rank=``);
        # warnings and errors still reach stderr
        devnull = sys.stdout = open(os.devnull, "w")
    try:
        print("WGSassign (wgsassign-tpu " + __version__
              + ", PyTorch/CUDA port)")
        # provenance log (reference WGSassign.py:127-141)
        writers.write_args_file(args.out, args, parser.parse_args([]),
                                rank=runtime.rank)
        name = (torch.cuda.get_device_name(runtime.device)
                if runtime.device.type == "cuda"
                else "the CPU (plain versions)")
        print(f"Device: {runtime.device} ({name}).")
        cards = (min(runtime.world, torch.cuda.device_count())
                 if runtime.device.type == "cuda" else 0)
        print(
            f"Mesh: {runtime.world} rank(s) on {cards} GPU(s) ({name}); "
            + (f"collectives over {runtime.backend}; "
               if runtime.world > 1 else "")
            + "SNP-axis data parallel.\n"
        )
        timer = RunTimer()
        timer.results["mesh"] = {"rank": runtime.rank, "world": runtime.world,
                                 "backend": runtime.backend,
                                 "device": str(runtime.device)}
        with maybe_profile(args.profile, runtime.device) as counts:
            _dispatch(args, runtime, timer, writers)
        timer.report(counts)
        shutdown_distributed(runtime)
    finally:
        sys.stdout = stdout
        if devnull is not None:
            devnull.close()
    return timer


def _dispatch(args, runtime, timer, writers):
    from wgsassign_tpu_torch.io.beagle import filter_sites_to_common, read_beagle
    from wgsassign_tpu_torch.models.common import to_device
    from wgsassign_tpu_torch.parallel.runtime import synchronize

    beagle = None
    cohort = None
    downsampled = None
    downsampled_cohort = None
    n_threads = args.threads if args.threads and args.threads > 0 else None
    several = runtime.world > 1
    window = dict(rank=runtime.rank, world=runtime.world)

    if args.beagle is not None and args.stream_ingest is not None:
        cohort, beagle, downsampled_cohort = _stream_ingest(
            args, runtime, timer, n_threads)
    elif args.beagle is not None and several and args.loo_downsampled_beagle:
        from wgsassign_tpu_torch.io.beagle import sharded_downsampled_pair

        print("Parsing Beagle files (per-rank row windows over the global "
              "site intersection).")
        with timer.phase("parse"):
            beagle, downsampled = sharded_downsampled_pair(
                args.beagle, args.loo_downsampled_beagle,
                site_multiple=args.partition_sites, n_threads=n_threads,
                **window)
        print(f"Loaded {beagle.n_sites} common sites and {beagle.n_inds} "
              f"individuals ({beagle.hi - beagle.lo} sites on this rank).")
    elif args.beagle is not None and several:
        from wgsassign_tpu_torch.io.beagle import read_beagle_sharded

        print("Parsing Beagle file (per-rank row windows).")
        with timer.phase("parse"):
            beagle = read_beagle_sharded(
                args.beagle, site_multiple=args.partition_sites,
                n_threads=n_threads, **window)
        print(f"Loaded {beagle.n_sites} sites and {beagle.n_inds} "
              f"individuals ({beagle.hi - beagle.lo} sites on this rank).")
    elif args.beagle is not None:
        print("Parsing Beagle file.")
        with timer.phase("parse"):
            beagle = read_beagle(args.beagle, n_threads=n_threads)
        print(f"Loaded {beagle.n_sites} sites and {beagle.n_inds} individuals.")
        _print_preview("sample_names", beagle.sample_names)
        _print_preview("site_names", beagle.site_names)

    if (args.loo_downsampled_beagle is not None and not several
            and args.stream_ingest is None):
        print("Parsing the optional downsampled Beagle file.")
        with timer.phase("parse"):
            downsampled = read_beagle(
                args.loo_downsampled_beagle, n_threads=n_threads
            )
        print(
            f"Loaded optional downsampled data set with {downsampled.n_sites} "
            f"sites and {downsampled.n_inds} individuals."
        )
        if beagle.sample_names != downsampled.sample_names:
            raise ValueError("Sample names in downsampled Beagle file do not match original.")
        print("Retaining only sites from the reference that are in the downsampled beagle file:")
        beagle = filter_sites_to_common(beagle, downsampled.site_names)
        print("Removing sites from downsampled set that were not in the reference (should not occur...):")
        downsampled = filter_sites_to_common(downsampled, beagle.site_names)
        if beagle.site_names != downsampled.site_names:
            raise ValueError("Site names in full and downsampled Beagle do not match after filtering.")

    if beagle is not None and cohort is None:
        with timer.phase("h2d"):
            cohort = to_device(beagle, runtime,
                               site_multiple=args.partition_sites)
            synchronize(runtime.device)

    if args.get_reference_af:
        _reference_af(args, beagle, cohort, downsampled, downsampled_cohort,
                      timer, writers)
    if args.get_pop_like:
        _pop_like(args, beagle, cohort, timer, writers)
    if args.get_reference_z_score or args.get_assignment_z_score:
        _z_scores(args, beagle, cohort, timer, writers)
    if (args.get_em_mix or args.get_mcmc_mix) and runtime.is_primary():
        # host numpy on a small matrix: one rank computes and writes
        _mixture(args, timer, writers)


def _stream_ingest(args, runtime, timer, n_threads):
    """``--stream_ingest ROWS``: the Beagle file (and the downsampled one)
    go to the device in site blocks; the GL matrices never exist on the
    host.  Returns ``(cohort, meta, downsampled_cohort or None)``."""
    from wgsassign_tpu_torch.models.common import stream_to_device
    from wgsassign_tpu_torch.parallel.runtime import synchronize

    keep_full = keep_ds = None
    if args.loo_downsampled_beagle:
        # the downsampled-LOO site intersection from one hash-scan pass per
        # file (8 bytes per site on the host), then masked streaming
        from wgsassign_tpu_torch.io.beagle import (
            scan_header_samples,
            scan_site_hashes,
            site_intersection_masks_hashed,
        )

        if (scan_header_samples(args.beagle)
                != scan_header_samples(args.loo_downsampled_beagle)):
            raise ValueError(
                "Sample names in downsampled Beagle file do not match original."
            )
        print("Scanning site names for the downsampled intersection.")
        with timer.phase("parse"):
            keep_full, keep_ds = site_intersection_masks_hashed(
                scan_site_hashes(args.beagle),
                scan_site_hashes(args.loo_downsampled_beagle),
            )

    def stream(path, keep):
        with timer.phase("parse"):
            out = stream_to_device(
                path, runtime, site_multiple=args.partition_sites,
                block_rows=args.stream_ingest or None, n_threads=n_threads,
                keep_mask=keep,
            )
            synchronize(runtime.device)
        return out

    print("Streaming Beagle file to device in site blocks.")
    cohort, meta, _ = stream(args.beagle, keep_full)
    print(
        f"Loaded {cohort.m_real} sites and {meta.n_inds} individuals "
        "(streamed; GL matrix resident on device only)."
    )
    _print_preview("sample_names", meta.sample_names)
    downsampled_cohort = None
    if args.loo_downsampled_beagle:
        print("Streaming the downsampled Beagle file.")
        downsampled_cohort, _, _ = stream(args.loo_downsampled_beagle,
                                          keep_ds)
    return cohort, meta, downsampled_cohort


def _reference_af(args, beagle, cohort, downsampled, downsampled_cohort,
                  timer, writers):
    """``--get_reference_af``, then ``--ne_obs`` and ``--loo`` when
    asked."""
    from wgsassign_tpu_torch.io.ids import read_ids
    from wgsassign_tpu_torch.models.reference_af import estimate_reference_af

    print("Parsing reference population ID file.")
    if not os.path.isfile(args.pop_af_IDs or ""):
        raise FileNotFoundError("Reference population ID file does not exist!!")
    popmap = read_ids(args.pop_af_IDs)
    rank = cohort.runtime.rank
    with timer.phase("reference_af"):
        res = estimate_reference_af(
            beagle, popmap, args.maf_iter, args.maf_tole, cohort=cohort,
            checkpoint_path=(args.out + ".em.ckpt.npz"
                             if args.em_checkpoint else None),
        )
    timer.results["reference_af"] = res
    print(f"EM (MAF) engine: {res.engine}")
    for pop, it, conv in zip(res.pops, res.iters, res.converged):
        status = f"converged at iteration: {it}" if conv else \
                 f"did not converge within {args.maf_iter} iterations"
        print(f"EM (MAF) population {pop}: {status}")
    writers.write_pop_af(args.out, res.af, rank=rank)
    print(f"Saved reference population allele frequencies as {args.out}"
          ".pop_af.npy (Binary - np.float32)\n")
    print(f"Column order of populations is: {res.pops}")
    writers.write_pop_names(args.out, res.pops, rank=rank)
    print(f"Saved reference population names as {args.out}.pop_names.txt\n")

    if args.ne_obs:
        from wgsassign_tpu_torch.models.ne import effective_sample_sizes

        print("Estimating Fisher information.")
        with timer.phase("ne"):
            ne = effective_sample_sizes(beagle, res.af, popmap, cohort=cohort)
        writers.write_ne_outputs(args.out, ne.f_obs, ne.ne_obs, res.pops,
                                 rank=rank)
        print(f"Saved observed Fisher information as {args.out}.fisher_obs.npy")
        print(f"Saved per-locus effective sample sizes as {args.out}.ne_obs.npy")
        print(f"Saved population effective sample sizes as {args.out}.ne_obs.txt")
        print("Estimating individual effective sample sizes.")
        writers.write_ne_ind(args.out, ne.ne_ind, rank=rank)
        print(f"Saved individual effective sample sizes as {args.out}.ne_ind.txt")

    if not args.loo:
        return
    from wgsassign_tpu_torch.models.loo import leave_one_out

    print("Performing leave-one-out cross validation.")
    with timer.phase("loo"):
        loo_res = leave_one_out(
            beagle,
            res.af,
            popmap,
            args.maf_iter,
            args.maf_tole,
            downsampled=downsampled,
            num_partitions=args.partition_sites,
            cohort=cohort,
            downsampled_cohort=downsampled_cohort,
            compat_af_mutation=not args.loo_clean_af,
            verbose=True,
            f64_sums=not args.f32_sums,
            checkpoint_path=(args.out + ".loo.ckpt"
                             if args.em_checkpoint else None),
            af_t_dev=res.af_t_dev,
        )
    timer.results["loo"] = loo_res
    print("LOO EM engines: " + ", ".join(
        f"{pop}={eng}" for pop, eng in zip(res.pops, loo_res.engines)))
    suffix = ("_downsampled"
              if downsampled is not None or downsampled_cohort is not None
              else "")
    outfile = f"{args.out}.pop_like_LOO{suffix}.tsv"
    writers.write_assignment_matrix(
        outfile, loo_res.ll, beagle.sample_names, list(res.pops),
        print_part_column=False, sample_locations=popmap.pop_labels,
        doing_LOO=True, rank=rank,
    )
    print(f"Saved leave-one-out cross validation log likelihoods as {outfile}")
    if args.partition_sites > 1:
        partfile = (f"{args.out}.pop_like_LOO{suffix}_partitions_"
                    f"{args.partition_sites}.tsv.gz")
        writers.write_assignment_matrix(
            partfile, loo_res.parts, beagle.sample_names, list(res.pops),
            partition_count=args.partition_sites, print_part_column=True,
            sample_locations=popmap.pop_labels, doing_LOO=True, rank=rank,
        )
        print(f"Saved partitioned LOO log likelihoods as {partfile}")
    print(f"Column order of populations is: {res.pops}")


def _pop_like(args, beagle, cohort, timer, writers):
    """``--get_pop_like``: log-likelihoods against ``--pop_af_file``."""
    import numpy as np

    from wgsassign_tpu_torch.models.assign import assignment_loglikelihoods

    if beagle is None:
        raise ValueError("--get_pop_like needs the --beagle file")
    print("Parsing population allele frequency file.")
    if not os.path.isfile(args.pop_af_file or ""):
        raise FileNotFoundError(
            "Population allele frequency file does not exist!!")
    af = np.load(args.pop_af_file)
    print("Calculating likelihood of population assignment")
    print(f"{beagle.n_inds} individuals to assign to {af.shape[1]} populations")
    with timer.phase("pop_like"):
        ll = assignment_loglikelihoods(beagle, af, cohort=cohort,
                                       f64_sums=not args.f32_sums)
    writers.write_loglike_txt(args.out, ll, rank=cohort.runtime.rank)
    print(f"Saved population assignment log likelihoods as {args.out}"
          ".pop_like.txt (text)")


def _z_scores(args, beagle, cohort, timer, writers):
    """``--get_reference_z_score`` and/or ``--get_assignment_z_score``."""
    import numpy as np

    from wgsassign_tpu_torch.io.ad import read_allele_depths
    from wgsassign_tpu_torch.io.ids import read_ids, read_pop_names
    from wgsassign_tpu_torch.models.common import upload_allele_depths
    from wgsassign_tpu_torch.parallel.runtime import synchronize

    if beagle is None:
        raise ValueError("z-scores need the --beagle file")
    print("Parsing population ID file.")
    if not os.path.isfile(args.pop_af_IDs or ""):
        raise FileNotFoundError("Population ID file does not exist!!")
    popmap = read_ids(args.pop_af_IDs)
    print("Parsing individual allele depths file.")
    if not os.path.isfile(args.ind_ad_file or ""):
        raise FileNotFoundError("Individual allele depths file does not exist!")
    with timer.phase("parse_ad"):
        ad = read_allele_depths(args.ind_ad_file, n_sites=cohort.m_real,
                                n_inds=beagle.n_inds)
    # once, beside the GL planes: this rank's rows, in the narrowest type
    with timer.phase("h2d_ad"):
        ad = upload_allele_depths(ad, cohort)
        synchronize(cohort.runtime.device)
    if not os.path.isfile(args.pop_names or ""):
        raise FileNotFoundError("Population names file does not exist!!")
    pops = read_pop_names(args.pop_names)
    n = beagle.n_inds
    if n != popmap.n_inds:
        raise ValueError(
            "Number of individuals in beagle and reference ID file do not match!")
    threshold = args.allele_count_threshold or 0
    if threshold < 0:
        raise ValueError(
            "Allele count threshold needs to be greater than/equal to 0!")
    ind_start = args.ind_start or 0
    ind_end = args.ind_end if args.ind_end is not None else n
    if not (0 <= ind_start < n and 0 < ind_end <= n and ind_start < ind_end):
        raise ValueError("Individual index range out of bounds!")

    if args.get_reference_z_score:
        from wgsassign_tpu_torch.models.zscore import reference_z_scores

        with timer.phase("zscore"):
            res = reference_z_scores(
                beagle, ad, popmap, ind_start, ind_end, threshold,
                args.single_read_threshold, args.maf_iter, args.maf_tole,
                cohort=cohort, verbose=True,
                error_rate=args.zscore_error_rate, timer=timer,
                f64_sums=not args.f32_sums,
            )
        timer.results["reference_z"] = res
        print(f"Reference z-score EM: {res.structure} (kept fraction "
              f"{res.fill:.4f}), engine {res.engine}, iterations "
              f"{res.em_iters.min()}..{res.em_iters.max()}")
        writers.write_z_scores(args.out, res.z, reference_mode=True,
                               rank=cohort.runtime.rank)
        print(f"Saved {len(res.z)} individual z-scores as {args.out}"
              ".reference_z_ind.txt (text)")

    if args.get_assignment_z_score:
        from wgsassign_tpu_torch.models.zscore import assignment_z_scores

        if not args.pop_af_file:
            raise ValueError(
                "--get_assignment_z_score requires --pop_af_file")
        af = np.load(args.pop_af_file)
        with timer.phase("zscore"):
            res = assignment_z_scores(
                beagle, ad, popmap.pop_labels, af, pops, ind_start, ind_end,
                threshold, args.single_read_threshold, cohort=cohort,
                verbose=True, error_rate=args.zscore_error_rate, timer=timer,
                f64_sums=not args.f32_sums,
            )
        timer.results["assignment_z"] = res
        writers.write_z_scores(args.out, res.z, reference_mode=False,
                               rank=cohort.runtime.rank)
        print(f"Saved {len(res.z)} individual z-scores as {args.out}"
              ".z_ind.txt (text)")


def _mixture(args, timer, writers):
    """``--get_em_mix`` / ``--get_mcmc_mix`` on a ``--pop_like`` file (host
    numpy; needs no Beagle file and touches no device data)."""
    import numpy as np

    from wgsassign_tpu_torch.io.ids import read_ids
    from wgsassign_tpu_torch.models.mixture import (
        em_mixture,
        format_mixture_output,
        mcmc_mixture,
    )

    print("Parsing population assignment likelihood file.")
    if not os.path.isfile(args.pop_like or ""):
        raise FileNotFoundError(
            "Population assignment log likelihood file does not exist!!")
    if not os.path.isfile(args.pop_like_IDs or ""):
        raise FileNotFoundError("ID file does not exist!!")
    ll_mat = np.atleast_2d(np.loadtxt(args.pop_like))
    harvest_labels = read_ids(args.pop_like_IDs).pop_labels
    if args.get_em_mix:
        print("Calculating mixture proportions with EM")
        with timer.phase("mixture"):
            res = em_mixture(ll_mat, harvest_labels, args.mixture_iter,
                             stable=args.stable_mix)
        writers.write_mixture(args.out, format_mixture_output(res), mcmc=False)
        print(f"Saved EM mixture proportions {args.out}.em_mix.txt (text)")
    if args.get_mcmc_mix:
        print("Calculating mixture proportions with MCMC")
        with timer.phase("mixture"):
            res = mcmc_mixture(ll_mat, harvest_labels, args.mixture_iter,
                               seed=args.mcmc_seed,
                               posterior_mean=not args.mcmc_last_draw)
        writers.write_mixture(args.out, format_mixture_output(res), mcmc=True)
        print(f"Saved MCMC mixture proportions {args.out}.mcmc_mix.txt (text)")


def _print_preview(name, items):
    n = len(items)
    if n <= 4:
        preview = ", ".join(items)
    else:
        preview = ", ".join(items[:2]) + ", ..., " + ", ".join(items[-2:])
    label = "samples" if "sample" in name else "sites"
    print(f"{name}: {n} {label} total: {preview}")


if __name__ == "__main__":
    main()
