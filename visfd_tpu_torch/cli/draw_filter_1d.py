"""draw_filter_1D: evaluate/plot 1-D profiles of the -gauss / -ggauss
/ -dog / -dogg / -log filters (``bin/filter_mrc/draw_filter_1D.py``).

Prints "x h(x)" rows to stdout; optional -plot writes a PNG.

A copy of ``visfd_tpu/cli/draw_filter_1d.py``.  No device is
involved: it evaluates 401 samples of a 1-D profile.
"""

from __future__ import annotations

import sys

import numpy as np


def profile(kind, params, x):
    if kind == "-gauss":
        A, a = params
        return A * np.exp(-0.5 * (x / a) ** 2)
    if kind == "-ggauss":
        A, a, m = params
        return A * np.exp(-np.abs(x / a) ** m)
    if kind == "-dog":
        A, B, a, b = params
        return (A * np.exp(-0.5 * (x / a) ** 2)
                - B * np.exp(-0.5 * (x / b) ** 2))
    if kind == "-dogg":
        A, B, a, b, m, n = params
        return (A * np.exp(-np.abs(x / a) ** m)
                - B * np.exp(-np.abs(x / b) ** n))
    if kind == "-log":
        # scale-normalized LoG profile via the DoG approximation
        sigma, delta = params
        a = sigma * (1 - 0.5 * delta)
        b = sigma * (1 + 0.5 * delta)
        ga = np.exp(-0.5 * (x / a) ** 2) / (a * np.sqrt(2 * np.pi))
        gb = np.exp(-0.5 * (x / b) ** 2) / (b * np.sqrt(2 * np.pi))
        return (ga - gb) / (delta * delta)
    raise ValueError(f"unknown filter {kind}")


N_ARGS = {"-gauss": 2, "-ggauss": 3, "-dog": 4, "-dogg": 6, "-log": 2}


def run(argv) -> int:
    args = list(argv)
    plot = "-plot" in args
    if plot:
        args.remove("-plot")
    if not args or args[0] not in N_ARGS:
        print("Usage: draw_filter_1D (-gauss A a | -ggauss A a m | "
              "-dog A B a b | -dogg A B a b m n | -log sigma delta) "
              "[xmax] [-plot]", file=sys.stderr)
        return 1
    kind = args[0]
    n = N_ARGS[kind]
    params = [float(v) for v in args[1:1 + n]]
    xmax = float(args[1 + n]) if len(args) > 1 + n else \
        5.0 * max(abs(p) for p in params[-2:])
    x = np.linspace(-xmax, xmax, 401)
    h = profile(kind, params, x)
    for xi, hi in zip(x, h):
        print(f"{xi:.6g} {hi:.6g}")
    if plot:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        plt.plot(x, h)
        plt.xlabel("x")
        plt.ylabel("h(x)")
        plt.savefig("filter_1d.png")
    return 0


def main():
    return run(sys.argv[1:])


if __name__ == "__main__":
    sys.exit(main())
