"""Command-line entry point of the port: ``--get_reference_af [--loo]``.

Takes the reference's flags (the argparse ``parser`` of
``wgsassign_tpu.cli``) and writes the same files through
``wgsassign_tpu.io.writers``: ``.args``, ``.pop_af.npy``,
``.pop_names.txt``, ``.pop_like_LOO[_downsampled].tsv`` and, with
``--partition_sites``, the partition ``.tsv.gz``.  Analyses not ported yet
raise ``NotImplementedError`` naming the flag; none is ignored.

Runs on ``cuda:0`` unless :func:`main` is given another ``device``; without
CUDA it raises.  ``device="cpu"`` (a Python argument, not a flag) runs the
kernels' plain PyTorch twins, for tests.
"""

from __future__ import annotations

import os
import sys

from wgsassign_tpu.cli import parser
from wgsassign_tpu.version import __version__

# flag -> ROADMAP item that ports it (ROADMAP.md, "Modules to port")
_NOT_PORTED = {
    "get_pop_like": "--get_pop_like (ROADMAP item 8)",
    "ne_obs": "--ne_obs (ROADMAP item 9)",
    "get_assignment_z_score": "--get_assignment_z_score (ROADMAP item 10)",
    "get_reference_z_score": "--get_reference_z_score (ROADMAP item 10)",
    "get_em_mix": "--get_em_mix (ROADMAP item 11)",
    "get_mcmc_mix": "--get_mcmc_mix (ROADMAP item 11)",
    "stream_ingest": "--stream_ingest (ROADMAP item 12)",
    "devices": "--devices (ROADMAP item 13)",
    "use_pallas": "--use_pallas (no counterpart: the GPU always runs the "
                  "CUDA kernels)",
    "no_pallas": "--no_pallas (no counterpart: the GPU always runs the "
                 "CUDA kernels)",
    "debug_checks": "--debug_checks (ROADMAP item 14)",
    "profile": "--profile (ROADMAP item 14)",
}


def _check_ported(args) -> None:
    defaults = vars(parser.parse_args([]))
    for dest, what in _NOT_PORTED.items():
        if getattr(args, dest) != defaults[dest]:
            raise NotImplementedError(
                f"{what} is not ported to wgsassign_tpu_torch yet; run it "
                "with the JAX package (wgsassign-tpu)"
            )


def main(argv=None, device=None):
    """Run the CLI.  ``device`` defaults to ``cuda:0`` and must be given as
    ``"cpu"`` explicitly to run without a GPU."""
    args = parser.parse_args(argv)
    n_args = len(sys.argv) - 1 if argv is None else len(argv)
    if n_args < 1:
        parser.print_help()
        sys.exit()
    _check_ported(args)
    if args.loo_downsampled_beagle and not args.loo:
        raise ValueError(
            "The --loo_downsampled_beagle option requires that --loo is also specified."
        )
    print("WGSassign (wgsassign-tpu " + __version__ + ", PyTorch/CUDA port)")

    import torch

    from wgsassign_tpu.io import writers
    from wgsassign_tpu.obs.log import setup_logging
    from wgsassign_tpu.obs.profiling import RunTimer
    from wgsassign_tpu_torch.parallel.runtime import make_runtime

    setup_logging(args.log_level)
    runtime = make_runtime("cuda:0" if device is None else device,
                           fast_math=not args.no_fast_em)
    # provenance log (reference WGSassign.py:127-141)
    writers.write_args_file(args.out, args, parser.parse_args([]))
    name = (torch.cuda.get_device_name(runtime.device)
            if runtime.device.type == "cuda" else "the CPU (plain versions)")
    print(f"Device: {runtime.device} ({name}).\n")
    timer = RunTimer()
    _dispatch(args, runtime, timer, writers)
    timer.report()
    return timer


def _dispatch(args, runtime, timer, writers):
    from wgsassign_tpu.io.beagle import filter_sites_to_common, read_beagle
    from wgsassign_tpu.io.ids import read_ids
    from wgsassign_tpu_torch.models.common import to_device

    beagle = None
    cohort = None
    downsampled = None
    n_threads = args.threads if args.threads and args.threads > 0 else None

    if args.beagle is not None:
        print("Parsing Beagle file.")
        with timer.phase("parse"):
            beagle = read_beagle(args.beagle, n_threads=n_threads)
        print(f"Loaded {beagle.n_sites} sites and {beagle.n_inds} individuals.")
        _print_preview("sample_names", beagle.sample_names)
        _print_preview("site_names", beagle.site_names)

    if args.loo_downsampled_beagle is not None:
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

    if beagle is not None:
        with timer.phase("h2d"):
            cohort = to_device(beagle, runtime,
                               site_multiple=args.partition_sites)
            _sync(runtime)

    if not args.get_reference_af:
        return
    from wgsassign_tpu_torch.models.reference_af import estimate_reference_af

    print("Parsing reference population ID file.")
    if not os.path.isfile(args.pop_af_IDs or ""):
        raise FileNotFoundError("Reference population ID file does not exist!!")
    popmap = read_ids(args.pop_af_IDs)
    with timer.phase("reference_af"):
        res = estimate_reference_af(
            beagle, popmap, args.maf_iter, args.maf_tole, cohort=cohort,
            checkpoint_path=(args.out + ".em.ckpt.npz"
                             if args.em_checkpoint else None),
        )
    em_secs = timer.totals["reference_af"]
    total_updates = float(
        beagle.n_sites * sum(
            int(it) * int(sz) for it, sz in zip(res.iters, popmap.pop_sizes)
        )
    )
    print(f"EM throughput: {total_updates / max(em_secs, 1e-9):.3g} "
          "site-individual GL updates/s")
    for pop, it, conv in zip(res.pops, res.iters, res.converged):
        status = f"converged at iteration: {it}" if conv else \
                 f"did not converge within {args.maf_iter} iterations"
        print(f"EM (MAF) population {pop}: {status}")
    writers.write_pop_af(args.out, res.af)
    print(f"Saved reference population allele frequencies as {args.out}"
          ".pop_af.npy (Binary - np.float32)\n")
    print(f"Column order of populations is: {res.pops}")
    writers.write_pop_names(args.out, res.pops)
    print(f"Saved reference population names as {args.out}.pop_names.txt\n")

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
            compat_af_mutation=not args.loo_clean_af,
            verbose=True,
            f64_sums=not args.f32_sums,
            checkpoint_path=(args.out + ".loo.ckpt"
                             if args.em_checkpoint else None),
            af_t_dev=res.af_t_dev,
        )
    loo_secs = timer.totals["loo"]
    sizes_of = dict(zip(popmap.pops, popmap.pop_sizes))
    pairwise_updates = float(cohort.m_real) * sum(
        int(it) * int(sizes_of[lab])
        for it, lab in zip(loo_res.iters, popmap.pop_labels)
    )
    print(f"LOO EM throughput: {pairwise_updates / max(loo_secs, 1e-9):.3g} "
          "pairwise site-member updates/s")
    suffix = "_downsampled" if downsampled is not None else ""
    outfile = f"{args.out}.pop_like_LOO{suffix}.tsv"
    writers.write_assignment_matrix(
        outfile, loo_res.ll, beagle.sample_names, list(res.pops),
        print_part_column=False, sample_locations=popmap.pop_labels,
        doing_LOO=True,
    )
    print(f"Saved leave-one-out cross validation log likelihoods as {outfile}")
    if args.partition_sites > 1:
        partfile = (f"{args.out}.pop_like_LOO{suffix}_partitions_"
                    f"{args.partition_sites}.tsv.gz")
        writers.write_assignment_matrix(
            partfile, loo_res.parts, beagle.sample_names, list(res.pops),
            partition_count=args.partition_sites, print_part_column=True,
            sample_locations=popmap.pop_labels, doing_LOO=True,
        )
        print(f"Saved partitioned LOO log likelihoods as {partfile}")
    print(f"Column order of populations is: {res.pops}")


def _sync(runtime) -> None:
    """Wait for the device, so a phase's wall time includes its work."""
    if runtime.device.type == "cuda":
        import torch

        torch.cuda.synchronize(runtime.device)


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
