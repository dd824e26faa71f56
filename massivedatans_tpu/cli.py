"""Command-line interface.

Replaces the reference's script-per-task layout with one entry point:

    python -m massivedatans_tpu gen horns 10000
    python -m massivedatans_tpu fit data_widths_10000.hdf5 100
    python -m massivedatans_tpu check <output.out8.hdf5>

``fit`` mirrors ``sample.py``: same positional arguments (data file, ndata),
same env-var knobs (CONSTRAINER, NLIVE_POINTS, ...), same output files.
"""

from __future__ import annotations

import argparse
import logging
import sys

import numpy as np


def _make_cli_mesh(args):
    """Device mesh from --devices/--model-parallel (None = single device).

    ``--devices N`` is the size of the DATASET axis; with
    ``--model-parallel M`` the mesh uses N*M devices total (data=N,
    model=M). ``--model-parallel M`` alone shards datasets over the
    remaining ``len(devices) // M``. Requesting more devices than exist is
    an error (no silent truncation)."""
    if args.devices <= 1 and args.model_parallel <= 1:
        return None
    import jax

    from massivedatans_tpu.parallel import make_mesh

    devs = jax.devices()
    mp = max(1, args.model_parallel)
    n_data = args.devices if args.devices > 1 else max(1, len(devs) // mp)
    need = n_data * mp
    if need > len(devs):
        raise SystemExit(
            f"requested mesh data={n_data} x model={mp} = {need} devices, "
            f"but only {len(devs)} are available"
        )
    mesh = make_mesh(devs[:need], model_parallel=mp)
    print(f"mesh: {dict(mesh.shape)}", file=sys.stderr)
    return mesh


def _log_device():
    """Name the device the fit runs on, so a fall-back to the CPU shows."""
    import jax

    devs = jax.devices()
    print(f"device: {devs[0].platform} {devs[0].device_kind} "
          f"x{len(devs)}", file=sys.stderr)


def cmd_gen(args):
    from massivedatans_tpu.datagen.generators import (
        GENERATORS, FILENAME_STEMS, save_dataset,
    )

    gen = GENERATORS[args.kind]
    data = gen(args.N, seed=args.seed)
    path = args.out or FILENAME_STEMS[args.kind].format(N=args.N)
    save_dataset(data, path)
    print(f"wrote {path}: x{data['x'].shape} y{data['y'].shape}")


def cmd_fit(args):
    from massivedatans_tpu.config import RunConfig
    from massivedatans_tpu.io.hdf5io import (
        load_spectra, output_prefix, write_results,
    )
    from massivedatans_tpu.models.gaussline import make_gaussline_problem
    from massivedatans_tpu.ns.integrator import multi_nested_integrator

    cfg = RunConfig.from_env(
        **{k: v for k, v in dict(
            nlive_points=args.nlive,
            tolerance=args.tolerance,
            max_samples=args.max_samples,
            constrainer=args.constrainer,
        ).items() if v is not None}
    )
    x, y = load_spectra(args.data, args.ndata)
    problem = make_gaussline_problem(x, y, noise_level=args.noise_level)
    _log_device()
    mesh = _make_cli_mesh(args)
    print(f"fitting {problem.ndata} datasets, nlive={cfg.nlive_points}, "
          f"constrainer={cfg.constrainer}", file=sys.stderr)
    result = multi_nested_integrator(
        problem, cfg, progress=not args.quiet, mesh=mesh,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every,
    )
    prefix = output_prefix(args.data, cfg.constrainer, cfg.nlive_points,
                           problem.ndata)
    write_results(prefix, result)
    print("logZ = %.1f +- %.1f" % (result.logZ[0], result.logZerr[0]))
    print("ndraws:", result.ndraws, "niter:", result.u.shape[0])
    print("wrote", prefix + ".hdf5")


def cmd_check(args):
    """Summarize an output file (reference checkoutput.py:8-42)."""
    from massivedatans_tpu.io.hdf5io import read_results

    for path in args.files:
        out = read_results(path)
        print(path)
        logZ, logZerr = out["logZ"], out["logZerr"]
        print("logZ[0] = %.1f +- %.1f" % (logZ[0], logZerr[0]))
        print("ndraws:", int(out["ndraws"]))
        w = out["w"] + out["L"]
        ndata = w.shape[1]
        for d in range(min(ndata, args.max_datasets)):
            wd = w[:, d].astype(np.float64)
            wd[~np.isfinite(wd)] = -np.inf
            p = np.exp(wd - wd.max())
            p /= p.sum()
            i = np.random.choice(np.arange(len(p)), size=1000, p=p)
            xs = out["x"][i, d, :]
            stats = "  ".join(
                f"p{j}={xs[:, j].mean():.3f}+-{xs[:, j].std():.3f}"
                for j in range(xs.shape[1])
            )
            print(f"  dataset {d}: logZ={logZ[d]:.2f}+-{logZerr[d]:.2f}  {stats}")


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    from massivedatans_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    p = argparse.ArgumentParser(prog="massivedatans_tpu")
    sub = p.add_subparsers(dest="cmd", required=True)

    g = sub.add_parser("gen", help="generate synthetic spectra")
    g.add_argument("kind", choices=["horns", "nothing", "simple", "bright",
                                    "faint", "agn", "realistic"])
    g.add_argument("N", type=int)
    g.add_argument("--seed", type=int, default=None)
    g.add_argument("--out", default=None)
    g.set_defaults(fn=cmd_gen)

    f = sub.add_parser("fit", help="run joint nested sampling (sample.py)")
    f.add_argument("data")
    f.add_argument("ndata", type=int)
    f.add_argument("--nlive", type=int, default=None)
    f.add_argument("--tolerance", type=float, default=None)
    f.add_argument("--max-samples", type=int, default=None)
    f.add_argument("--constrainer", default=None)
    f.add_argument("--noise-level", type=float, default=0.01)
    f.add_argument("--quiet", action="store_true")
    f.add_argument("--checkpoint-dir", default=None,
                   help="persist sampler state here and resume from it "
                        "(new capability; the reference loses a crashed run)")
    f.add_argument("--checkpoint-every", type=int, default=10,
                   help="chunks between state checkpoints")
    f.add_argument("--devices", type=int, default=1,
                   help="shard datasets over this many devices "
                        "(a jax.sharding Mesh; >1 enables the mesh path)")
    f.add_argument("--model-parallel", type=int, default=1,
                   help="also shard the spectral axis over this many "
                        "devices (2-D data x model mesh, the SP/CP analog)")
    f.set_defaults(fn=cmd_fit)

    c = sub.add_parser("check", help="summarize output files (checkoutput.py)")
    c.add_argument("files", nargs="+")
    c.add_argument("--max-datasets", type=int, default=4)
    c.set_defaults(fn=cmd_check)

    m = sub.add_parser("musefit", help="fit a MUSE datacube (musefuse.py)")
    m.add_argument("cube")
    m.add_argument("region")
    m.add_argument("zlo", type=float)
    m.add_argument("zhi", type=float)
    m.add_argument("templates", nargs="+")
    m.add_argument("--model", default=None,
                   choices=["FULL", "ZSOL"])
    m.add_argument("--maxdata", type=int, default=None)
    m.add_argument("--nlive", type=int, default=None)
    m.add_argument("--max-samples", type=int, default=100000)
    m.add_argument("--out", default=None)
    m.add_argument("--ages-file", default=None,
                   help="text file with one template age (years) per line; "
                        "default: the reference BC03 grid (musefuse.py:190)")
    m.add_argument("--checkpoint-dir", default=None)
    m.add_argument("--devices", type=int, default=1,
                   help="shard spaxels over this many devices")
    m.add_argument("--model-parallel", type=int, default=1,
                   help="also shard the wavelength axis (2-D mesh)")
    m.set_defaults(fn=cmd_musefit)

    r = sub.add_parser(
        "refine",
        help="gradient-based refinement/cross-check of an NS run: batched "
             "per-dataset HMC posteriors and/or mean-field VI evidences "
             "(new capability; the reference is gradient-free)")
    r.add_argument("data", help="spectra HDF5, or a FITS cube with --muse")
    r.add_argument("output", help="the fit's .out8.hdf5 (seeds the chains)")
    r.add_argument("--backend", default="both", choices=["hmc", "vi", "both"])
    r.add_argument("--num-warmup", type=int, default=300)
    r.add_argument("--num-samples", type=int, default=300)
    r.add_argument("--vi-steps", type=int, default=1500)
    r.add_argument("--noise-level", type=float, default=0.01)
    r.add_argument("--max-datasets", type=int, default=4)
    r.add_argument("--muse", nargs=3, metavar=("REGION", "ZLO", "ZHI"),
                   default=None,
                   help="treat `data` as a MUSE cube: ds9 region, zlo, zhi")
    r.add_argument("--muse-templates", nargs="+", default=None)
    r.set_defaults(fn=cmd_refine)

    pe = sub.add_parser("plot-evidences",
                        help="Bayes factors vs no-signal (plotevidences.py)")
    pe.add_argument("data")
    pe.add_argument("output")
    pe.add_argument("--out", default="plotevidences.pdf")
    pe.set_defaults(fn=cmd_plot_evidences)

    ps = sub.add_parser("plot-scaling",
                        help="evals vs N scaling (plotscaling.py)")
    ps.add_argument("stats", nargs="+")
    ps.add_argument("--out", default="scaling.pdf")
    ps.set_defaults(fn=cmd_plot_scaling)

    pp_ = sub.add_parser("plot-posterior",
                         help="marginal posteriors (plotposterior.py)")
    pp_.add_argument("output")
    pp_.add_argument("--dataset", type=int, default=0)
    pp_.add_argument("--out", default="posterior.pdf")
    pp_.set_defaults(fn=cmd_plot_posterior)

    pb = sub.add_parser(
        "plot-bestfit",
        help="best-fit model vs data per dataset (musefuse.py emits these "
             "from inside the likelihood; here post-hoc)")
    pb.add_argument("data")
    pb.add_argument("output")
    pb.add_argument("--datasets", type=int, nargs="+", default=[0])
    pb.add_argument("--noise-level", type=float, default=0.01)
    pb.add_argument("--prefix", default="bestfit")
    pb.set_defaults(fn=cmd_plot_bestfit)

    pm = sub.add_parser(
        "plot-muse-posterior",
        help="per-spaxel posterior corner plots (plotmuseposterior.py)")
    pm.add_argument("output")
    pm.add_argument("--min-finite", type=int, default=4000)
    pm.add_argument("--size", type=int, default=100000)
    pm.add_argument("--prefix", default="museposterior")
    pm.set_defaults(fn=cmd_plot_muse_posterior)

    args = p.parse_args(argv)
    return args.fn(args)


def cmd_musefit(args):
    import os

    from massivedatans_tpu.muse.pipeline import run_musefit

    model = args.model or os.environ.get("MODEL", "FULL")
    maxdata = args.maxdata
    if maxdata is None:
        maxdata = int(os.environ.get("MAXDATA", 0))
    _log_device()
    mesh = _make_cli_mesh(args)
    result, problem, cube = run_musefit(
        args.cube, args.region, args.zlo, args.zhi, args.templates,
        model=model, maxdata=maxdata,
        nlive=args.nlive or int(os.environ.get("NLIVE_POINTS", 400)),
        max_samples=args.max_samples, out_prefix=args.out,
        checkpoint_dir=args.checkpoint_dir, mesh=mesh,
        ages_file=args.ages_file,
    )
    print("logZ = %.1f +- %.1f" % (result.logZ[0], result.logZerr[0]))
    print("ndraws:", result.ndraws)


def cmd_refine(args):
    import jax

    from massivedatans_tpu.io.hdf5io import load_spectra, read_results

    out = read_results(args.output)
    D = out["logZ"].shape[0]
    if args.muse is not None:
        from massivedatans_tpu.muse.likelihood import make_muse_problem
        from massivedatans_tpu.muse.model import load_template_grid
        from massivedatans_tpu.muse.pipeline import load_muse_cube

        region, zlo, zhi = args.muse
        cube = load_muse_cube(args.data, region, maxdata=D)
        md = load_template_grid(args.muse_templates,
                                data_wl_nm=cube.wavelength_nm,
                                zlo=float(zlo), zhi=float(zhi))
        problem = make_muse_problem(md, cube.y, cube.var)
    else:
        from massivedatans_tpu.models.gaussline import make_gaussline_problem

        x_grid, y = load_spectra(args.data, D)
        problem = make_gaussline_problem(
            x_grid, y, noise_level=args.noise_level)

    # seed each dataset's chain from one resampled NS posterior point
    w = (out["w"] + out["L"]).astype(np.float64)
    w[~np.isfinite(w)] = -np.inf
    rng = np.random.default_rng(0)
    init_u = np.empty((D, problem.ndim), np.float32)
    for d in range(D):
        p = np.exp(w[:, d] - w[:, d].max())
        p /= p.sum()
        init_u[d] = out["u"][rng.choice(len(p), p=p), d, :]

    if args.backend in ("hmc", "both"):
        from massivedatans_tpu.infer import run_hmc

        res = run_hmc(problem, jax.random.key(0), init_u=init_u,
                      num_warmup=args.num_warmup,
                      num_samples=args.num_samples)
        print(f"HMC: mean accept {float(np.mean(res.accept_rate)):.2f}")
        xs = np.asarray(res.x)
        for d in range(min(D, args.max_datasets)):
            stats = "  ".join(
                f"p{j}={xs[:, d, j].mean():.3f}+-{xs[:, d, j].std():.3f}"
                for j in range(problem.ndim))
            print(f"  dataset {d}: {stats}")
    if args.backend in ("vi", "both"):
        from massivedatans_tpu.infer import run_vi

        res = run_vi(problem, jax.random.key(1), init_u=init_u,
                     steps=args.vi_steps)
        iw = np.asarray(res.logZ_iw)
        dns = iw - out["logZ"]
        print(f"VI: median |logZ_IW - logZ_NS| = "
              f"{float(np.median(np.abs(dns))):.2f} "
              f"(NS MC error ~{float(np.median(out['logZerr'])):.2f})")
        for d in range(min(D, args.max_datasets)):
            print(f"  dataset {d}: logZ_IW={iw[d]:.2f}  "
                  f"logZ_NS={out['logZ'][d]:.2f}+-{out['logZerr'][d]:.2f}")


def cmd_plot_evidences(args):
    from massivedatans_tpu import postprocess as pp
    from massivedatans_tpu.io.hdf5io import load_spectra, read_results

    _, y = load_spectra(args.data)
    out = read_results(args.output)
    B = pp.plot_evidences(out, y[:, :out["logZ"].shape[0]], path=args.out)
    print(f"median log10 B = {np.median(B):.2f}; wrote {args.out}")


def cmd_plot_posterior(args):
    from massivedatans_tpu import postprocess as pp
    from massivedatans_tpu.io.hdf5io import read_results

    out = read_results(args.output)
    pp.plot_posterior(out, d=args.dataset, path=args.out)
    print("wrote", args.out)


def cmd_plot_bestfit(args):
    from massivedatans_tpu import postprocess as pp
    from massivedatans_tpu.io.hdf5io import load_spectra, read_results
    from massivedatans_tpu.models.gaussline import make_gaussline_problem

    out = read_results(args.output)
    x, y = load_spectra(args.data, out["logZ"].shape[0])
    problem = make_gaussline_problem(x, y, noise_level=args.noise_level)
    paths = pp.plot_bestfit(out, problem, datasets=args.datasets,
                            path_prefix=args.prefix)
    print(f"wrote {len(paths)} plots -> {args.prefix}_*.pdf")


def cmd_plot_muse_posterior(args):
    from massivedatans_tpu import postprocess as pp
    from massivedatans_tpu.io.hdf5io import read_results

    out = read_results(args.output)
    done = pp.plot_muse_posterior(out, min_finite=args.min_finite,
                                  size=args.size, path_prefix=args.prefix)
    print(f"plotted {len(done)} datasets -> {args.prefix}_*.pdf")


def cmd_plot_scaling(args):
    from massivedatans_tpu import postprocess as pp

    N, draws = pp.plot_scaling(args.stats, path=args.out)
    print("N:", list(N), "draws:", list(draws), "-> wrote", args.out)


if __name__ == "__main__":
    main()
