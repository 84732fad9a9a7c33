"""Plots of the accuracy experiments (the port's copy of
``ipoke_tpu/utils/plots.py``; the reference's utils/logging.py
make_errorbar_plot :979, make_nn_var_plot :1013, make_two_axes_plot :1050).

matplotlib is imported inside each function, with the Agg backend, so a
machine without it imports this module and fails only at the first plot
(``ModuleNotFoundError``), as the JAX package does.
"""
from __future__ import annotations

import os

import numpy as np


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _save(fig, path):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, dpi=120, bbox_inches="tight")
    _pyplot().close(fig)
    return path


def errorbar_plot(path, per_frame_mean, per_frame_std, ylabel="LPIPS", title=None):
    """A per-frame mean with its std as error bars, written to ``path``."""
    plt = _pyplot()
    frames = np.arange(len(per_frame_mean))
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.errorbar(frames, per_frame_mean, yerr=per_frame_std, fmt="-o", capsize=3)
    ax.set_xlabel("frame")
    ax.set_ylabel(ylabel)
    if title:
        ax.set_title(title)
    return _save(fig, path)


def two_axes_plot(path, x, y1, y2, labels=("LPIPS", "SSIM")):
    """``y1`` and ``y2`` over ``x`` on two y axes, written to ``path``."""
    plt = _pyplot()
    fig, ax1 = plt.subplots(figsize=(6, 4))
    ax1.plot(x, y1, "-o", color="tab:blue", label=labels[0])
    ax1.set_ylabel(labels[0], color="tab:blue")
    ax2 = ax1.twinx()
    ax2.plot(x, y2, "-s", color="tab:red", label=labels[1])
    ax2.set_ylabel(labels[1], color="tab:red")
    ax1.set_xlabel("frame")
    return _save(fig, path)


def violin_plot(path, groups: dict, ylabel="divergence"):
    """One violin per named group of values, written to ``path``."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.violinplot([np.asarray(v) for v in groups.values()], showmeans=True)
    ax.set_xticks(range(1, len(groups) + 1))
    ax.set_xticklabels(list(groups.keys()))
    ax.set_ylabel(ylabel)
    return _save(fig, path)
