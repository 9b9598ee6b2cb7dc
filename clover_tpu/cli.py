"""CLI with the reference's four modes (src/main.cpp:16-50):

    python -m clover_tpu -v   validation   (ops vs golden oracle)
    python -m clover_tpu -p   performance  (bandwidth/roofline tables)
    python -m clover_tpu -a   accuracy     (IHT/GD solver quality traces)
    python -m clover_tpu -g   grid search  (best mu / iterations per size)
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="clover_tpu",
        description="block-scaled quantized linear algebra")
    p.add_argument("-v", "--validate", action="store_true",
                   help="validate production ops against the golden "
                        "oracle across size sweeps")
    p.add_argument("-p", "--performance", action="store_true",
                   help="run the performance benchmark tables")
    p.add_argument("-a", "--accuracy", action="store_true",
                   help="run the IHT accuracy protocol (all precisions)")
    p.add_argument("-g", "--grid-search", action="store_true",
                   help="hyper-parameter grid search (best mu/iterations)")
    p.add_argument("--full", action="store_true",
                   help="exhaustive size sweeps (validation)")
    p.add_argument("--quick", action="store_true",
                   help="reduced size set (performance / search)")
    p.add_argument("--sharded", action="store_true",
                   help="-p: bench the shard_map path (mvm_psum / "
                        "iht_sharded) over the available device mesh")
    p.add_argument("--gd", action="store_true",
                   help="use gradient descent instead of IHT (-a; restricts "
                        "-g to the GD families)")
    p.add_argument("--mixed", action="store_true",
                   help="restrict -g to the mixed 4x8 families (reference "
                        "runs pure then mixed; default runs all four)")
    p.add_argument("--ladder19", action="store_true",
                   help="use the reference's full 19-size ladder for -g "
                        "(default: 12 sizes, 256..32768)")
    p.add_argument("--epochs", type=int, default=200,
                   help="accuracy-mode epochs (default 200)")
    p.add_argument("--no-sr", action="store_true",
                   help="disable stochastic rounding (deterministic mode)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from .harness.sysinfo import print_banner
    from .utils.compcache import enable as enable_compcache

    enable_compcache()

    if not any((args.validate, args.performance, args.accuracy,
                args.grid_search)):
        build_parser().print_help()
        return 0

    print_banner()
    print()

    ok = True
    if args.validate:
        from .harness.validate import run_validation
        ok = run_validation(full=args.full) and ok
    if args.performance:
        from .harness.perf import run_perf
        run_perf(quick=args.quick, sharded=args.sharded)
    if args.accuracy:
        from .harness.accuracy import run_accuracy
        run_accuracy(epochs=args.epochs, sr=not args.no_sr, gd=args.gd)
    if args.grid_search:
        # The reference's -g runs GD pure, IHT pure, GD mixed, IHT mixed
        # in one invocation (test/search/00_search.cpp:249-263), each with
        # all four precision columns per size.
        from .harness.search import (
            SEARCH_SIZES_FULL, SIZE_LADDER, run_search_full)
        kinds = [k for k in ("gd", "iht", "gd_mixed", "iht_mixed")
                 if (not args.gd or k.startswith("gd"))
                 and (not args.mixed or k.endswith("mixed"))]
        sizes = (SIZE_LADDER if args.ladder19 else SEARCH_SIZES_FULL)
        if args.quick:
            sizes = sizes[:2]
        results = run_search_full(sizes=sizes, kinds=tuple(kinds),
                                  log=lambda *a: None)
        for kind, rows in results.items():
            print(f"\n=== {kind} ===")
            print(f"{'bits':>5} {'m':>8} {'n':>8} {'K':>8} "
                  f"{'iters':>6} {'mu':>14} {'target':>10}")
            for row in rows:
                for bits, col in row["cols"].items():
                    it, mu = col if col else ("-", float("nan"))
                    print(f"{bits:>5} {row['m']:>8} {row['n']:>8} "
                          f"{row['K']:>8} {it:>6} {mu:>14.8f} "
                          f"{row['quality_target']:>10.6f}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
