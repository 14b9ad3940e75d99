"""Comparison figures: the reference's images/straggler.jpg, regenerated.

The reference ships one static figure claiming AGC "converges as quickly as
distributed GD and has faster overall runtime" (README.md:7-9). This module
renders that comparison from real run data (experiments.compare /
straggler_sweep output): training loss against *simulated cluster time* per
scheme, plus time-to-target bars — the two BASELINE.json north-star views.

Design notes (per the dataviz method): one axis per panel; categorical color
follows the *scheme* identity in a fixed slot order (never re-assigned when
a scheme is filtered out); 2px lines with direct end-labels plus a legend;
recessive grid; values readable from the saved .dat artifacts (the "table
view"). Palette: the validated reference instance (slots 1-8, light mode).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

# fixed categorical slots (validated adjacent-pair order; color follows the
# scheme entity — filtering schemes must not repaint survivors)
SCHEME_COLORS = {
    "naive": "#2a78d6",
    "approx": "#eb6834",
    "cyccoded": "#1baf7a",
    "repcoded": "#eda100",
    "avoidstragg": "#e87ba4",
    "partialcyccoded": "#008300",
    "partialrepcoded": "#4a3aa7",
    "randreg": "#e34948",
    "deadline": "#7a5f3a",
}
_FALLBACK = "#6b6a60"  # neutral "Other" gray for unknown labels
_INK = "#1a1a19"
_INK_2 = "#6b6a60"
_GRID = "#e8e7e0"


def _color(summary) -> str:
    return SCHEME_COLORS.get(summary.config.scheme.value, _FALLBACK)


def _style_axes(ax):
    for side in ("top", "right"):
        ax.spines[side].set_visible(False)
    for side in ("left", "bottom"):
        ax.spines[side].set_color(_GRID)
    ax.tick_params(colors=_INK_2, labelsize=8)
    ax.grid(True, color=_GRID, linewidth=0.6, zorder=0)
    ax.set_axisbelow(True)


def _end_labels(ax, ends: list[tuple[float, float, str]]) -> None:
    """Direct labels at line ends, de-conflicted: a label is nudged up only
    when another sits at BOTH a nearby x and a nearby y — labels far apart
    on the x axis don't fight and stay glued to their line ends."""
    y0, y1 = ax.get_ylim()  # full data range, not just the end points
    x0, x1 = ax.get_xlim()
    min_dy = 0.05 * ((y1 - y0) or 1.0)
    min_dx = 0.12 * ((x1 - x0) or 1.0)
    placed: list[tuple[float, float]] = []
    for x, y, label in sorted(ends, key=lambda e: e[1]):
        while any(
            abs(x - px) < min_dx and abs(y - py) < min_dy
            for px, py in placed
        ):
            y += min_dy
        placed.append((x, y))
        ax.annotate(
            label, (x, y), xytext=(6, 0), textcoords="offset points",
            fontsize=8, color=_INK, va="center",
        )


def save_comparison_figure(
    summaries: Sequence,
    path: str,
    title: Optional[str] = None,
) -> Optional[str]:
    """Loss-vs-simulated-time lines + time-to-target bars -> PNG.

    Returns the path, or None when matplotlib is unavailable (the numeric
    artifacts remain the source of truth either way).
    """
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:
        return None

    fig, (ax_loss, ax_ttt) = plt.subplots(
        1, 2, figsize=(10, 4), gridspec_kw={"width_ratios": [3, 2]}
    )
    fig.patch.set_facecolor("white")

    # panel A: training loss vs cumulative simulated cluster seconds
    ends = []
    for s in summaries:
        t = np.cumsum(s.timeset)
        c = _color(s)
        ax_loss.plot(t, s.training_loss, color=c, linewidth=2, zorder=3)
        ends.append((float(t[-1]), float(s.training_loss[-1]), s.label))
    _end_labels(ax_loss, ends)
    _style_axes(ax_loss)
    ax_loss.set_xlabel("simulated cluster time (s)", fontsize=9, color=_INK)
    ax_loss.set_ylabel("training loss", fontsize=9, color=_INK)
    ax_loss.margins(x=0.12)
    ax_loss.legend(
        [s.label for s in summaries],
        frameon=False,
        fontsize=8,
        labelcolor=_INK,
    )
    for line, s in zip(ax_loss.get_legend().legend_handles, summaries):
        line.set_color(_color(s))

    # panel B: simulated time to the shared target loss
    labels = [s.label for s in summaries]
    vals = [
        s.time_to_target if s.time_to_target is not None else np.nan
        for s in summaries
    ]
    ypos = np.arange(len(labels))
    for i, (v, s) in enumerate(zip(vals, summaries)):
        if np.isfinite(v):
            ax_ttt.barh(i, v, height=0.55, color=_color(s), zorder=3)
            ax_ttt.annotate(
                f"{v:.1f}s",
                (v, i),
                xytext=(4, 0),
                textcoords="offset points",
                fontsize=8,
                color=_INK,
                va="center",
            )
        else:
            ax_ttt.annotate(
                "target not reached",
                (0, i),
                xytext=(4, 0),
                textcoords="offset points",
                fontsize=8,
                color=_INK_2,
                va="center",
            )
    ax_ttt.set_yticks(ypos, labels)
    ax_ttt.invert_yaxis()
    _style_axes(ax_ttt)
    ax_ttt.grid(axis="y", visible=False)
    ax_ttt.set_xlabel(
        "simulated time to target loss (s)", fontsize=9, color=_INK
    )
    ax_ttt.margins(x=0.18)

    if title:
        fig.suptitle(title, fontsize=11, color=_INK)
    fig.tight_layout()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    fig.savefig(path, dpi=150, facecolor="white")
    plt.close(fig)
    return path


def save_sweep_figure(
    sweep: dict[str, Sequence], path: str, title: Optional[str] = None
) -> Optional[str]:
    """Time-to-target vs n_stragglers, one line per scheme — the
    BASELINE.json north-star curve."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:
        return None

    fig, ax = plt.subplots(figsize=(6, 4))
    fig.patch.set_facecolor("white")
    ends = []
    for label, summaries in sweep.items():
        xs = [s.config.n_stragglers for s in summaries]
        ys = [
            s.time_to_target if s.time_to_target is not None else np.nan
            for s in summaries
        ]
        c = _color(summaries[0])
        ax.plot(xs, ys, color=c, linewidth=2, marker="o", markersize=5,
                zorder=3)
        ends.append((float(xs[-1]), float(ys[-1]), label))
    _end_labels(ax, ends)
    _style_axes(ax)
    ax.set_xlabel("injected stragglers s", fontsize=9, color=_INK)
    ax.set_ylabel("simulated time to target loss (s)", fontsize=9, color=_INK)
    ax.margins(x=0.15)
    ax.legend(list(sweep), frameon=False, fontsize=8, labelcolor=_INK)
    for line, (label, summaries) in zip(
        ax.get_legend().legend_handles, sweep.items()
    ):
        line.set_color(_color(summaries[0]))
    if title:
        ax.set_title(title, fontsize=11, color=_INK)
    fig.tight_layout()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    fig.savefig(path, dpi=150, facecolor="white")
    plt.close(fig)
    return path
