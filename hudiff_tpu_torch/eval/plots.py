# Copied from hudiff_tpu/eval/plots.py.
"""Evaluation plots: ROC/PR curves, score distributions, mutation-overlap
venn diagrams, OASis prevalence curves. Rebuilds the plotting surface of
utils/evaluation.py:13-381 (the venn2 geometry is re-derived here in pure
matplotlib because the reference's matplotlib_venn dependency is external).
Matplotlib is optional; every function raises a clear error if unavailable.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np


def _plt():
    try:
        import matplotlib
        matplotlib.use('Agg')
        import matplotlib.pyplot as plt
        return plt
    except ImportError as e:
        raise RuntimeError('matplotlib not available for plotting') from e


def roc_curve_plot(y_true: Sequence[int], scores: Sequence[float],
                   path: str, label: str = 'model') -> float:
    """ROC curve + AUC (utils/evaluation.py ROC plots)."""
    from sklearn.metrics import auc, roc_curve
    fpr, tpr, _ = roc_curve(y_true, scores)
    a = auc(fpr, tpr)
    plt = _plt()
    fig, ax = plt.subplots(figsize=(5, 5))
    ax.plot(fpr, tpr, label=f'{label} (AUC={a:.3f})')
    ax.plot([0, 1], [0, 1], '--', color='grey')
    ax.set_xlabel('FPR')
    ax.set_ylabel('TPR')
    ax.legend()
    fig.savefig(path, dpi=150, bbox_inches='tight')
    plt.close(fig)
    return float(a)


def pr_curve_plot(y_true: Sequence[int], scores: Sequence[float],
                  path: str, label: str = 'model') -> float:
    from sklearn.metrics import average_precision_score, precision_recall_curve
    prec, rec, _ = precision_recall_curve(y_true, scores)
    ap = average_precision_score(y_true, scores)
    plt = _plt()
    fig, ax = plt.subplots(figsize=(5, 5))
    ax.plot(rec, prec, label=f'{label} (AP={ap:.3f})')
    ax.set_xlabel('Recall')
    ax.set_ylabel('Precision')
    ax.legend()
    fig.savefig(path, dpi=150, bbox_inches='tight')
    plt.close(fig)
    return float(ap)


def score_distributions(groups: Dict[str, Sequence[float]], path: str,
                        xlabel: str = 'score') -> None:
    """Overlaid histograms per group (e.g. mouse vs humanized T20/AbNatiV)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(6, 4))
    for name, vals in groups.items():
        vals = np.asarray([v for v in vals if np.isfinite(v)])
        if len(vals) == 0:
            continue
        ax.hist(vals, bins=30, alpha=0.5, label=f'{name} (n={len(vals)})',
                density=True)
    ax.set_xlabel(xlabel)
    ax.set_ylabel('density')
    ax.legend()
    fig.savefig(path, dpi=150, bbox_inches='tight')
    plt.close(fig)


def abnativ_profile(res_scores: Sequence[float], seq: str, path: str,
                    name: str = '', model_type: str = 'VH') -> None:
    """Per-position AbNatiV residue score profile with CDR shading
    (abnativ_scoring.plot_abnativ_profile, :31-58)."""
    from .. import constants as C
    plt = _plt()
    fig, ax = plt.subplots(figsize=(16, 4))
    ax.plot(res_scores, linewidth=2, color='darkorange', label=name)
    cdr = np.asarray(C.AHO_CDR_INDEX)
    for v in (1, 2, 3):
        cols = np.nonzero(cdr == v)[0]
        if len(cols):
            ax.axvspan(cols[0], cols[-1], alpha=0.08, color='forestgreen')
    ax.set_ylabel(f'AbNatiV {model_type} residue score')
    ax.set_xlabel('AHo position')
    if name:
        ax.legend()
    fig.savefig(path, dpi=150, bbox_inches='tight')
    plt.close(fig)

# ---------------------------------------------------------------------------
# Mutation-overlap venn diagrams (utils/evaluation.py:113-215)
# ---------------------------------------------------------------------------
# The reference draws these with matplotlib_venn.venn2; here the
# area-proportional two-circle geometry is solved directly: circle radii from
# the set areas, and the centre distance found by bisection so the lens
# (intersection) area matches the shared count.

OVERLAP_COLUMNS = ('Baseline only', 'Shared', 'Predicted only')


def mutation_overlap(parental, experimental, predicted) -> Dict[str, int]:
    """Mutation overlap between an experimental ('Baseline') humanization and
    a predicted one, both relative to the same parental chain.

    A mutation is (grid position, new residue); 'Shared' requires both the
    position and the substituted residue to agree (the quantity the
    reference's overlap venns report per antibody). Inputs are
    eval.metrics.GridChain objects on the same grid.
    """
    occ = (parental.occupied() | experimental.occupied()
           | predicted.occupied())
    base_only = shared = pred_only = 0
    for i in np.nonzero(occ)[0]:
        p, e, s = parental.grid[i], experimental.grid[i], predicted.grid[i]
        e_mut = e != p
        s_mut = s != p
        if e_mut and s_mut and e == s:
            shared += 1
        else:
            if e_mut:
                base_only += 1
            if s_mut:
                pred_only += 1
    return {'Baseline only': base_only, 'Shared': shared,
            'Predicted only': pred_only}


def overlap_table(parental_pairs, experimental_pairs, predicted_pairs,
                  names: Optional[Sequence[str]] = None) -> List[Dict]:
    """Per-antibody H+L mutation-overlap rows for plot_overlap /
    plot_overlap_venns. Each input is a sequence of (h_seq, l_seq)."""
    from .metrics import GridChain
    rows = []
    for k, ((ph, pl), (eh, el), (sh, sl)) in enumerate(
            zip(parental_pairs, experimental_pairs, predicted_pairs)):
        try:
            o_h = mutation_overlap(GridChain(ph, True, 'H'),
                                   GridChain(eh, True, 'H'),
                                   GridChain(sh, True, 'H'))
            o_l = mutation_overlap(GridChain(pl, False),
                                   GridChain(el, False),
                                   GridChain(sl, False))
        except ValueError:
            continue
        row = {c: o_h[c] + o_l[c] for c in OVERLAP_COLUMNS}
        row['name'] = names[k] if names is not None else f'ab{k}'
        rows.append(row)
    return rows


def _lens_area(d: float, r1: float, r2: float) -> float:
    """Intersection area of two circles with radii r1, r2 at distance d."""
    if d >= r1 + r2:
        return 0.0
    if d <= abs(r1 - r2):
        return np.pi * min(r1, r2) ** 2
    a1 = np.arccos(np.clip((d * d + r1 * r1 - r2 * r2) / (2 * d * r1), -1, 1))
    a2 = np.arccos(np.clip((d * d + r2 * r2 - r1 * r1) / (2 * d * r2), -1, 1))
    tri = 0.5 * np.sqrt(max(0.0, (-d + r1 + r2) * (d + r1 - r2)
                            * (d - r1 + r2) * (d + r1 + r2)))
    return r1 * r1 * a1 + r2 * r2 * a2 - tri


def _venn2_layout(a_only: float, shared: float, b_only: float):
    """Solve the area-proportional venn2 layout.

    Returns (r1, r2, d): radii of the two circles and their centre distance
    such that circle areas are a_only+shared and b_only+shared and the lens
    area is `shared` (bisection; areas in arbitrary units).
    """
    A = max(a_only + shared, 1e-9)
    B = max(b_only + shared, 1e-9)
    r1 = np.sqrt(A / np.pi)
    r2 = np.sqrt(B / np.pi)
    if shared <= 0:
        return r1, r2, (r1 + r2) * 1.1
    lo, hi = abs(r1 - r2), r1 + r2
    for _ in range(80):
        mid = 0.5 * (lo + hi)
        if _lens_area(mid, r1, r2) > shared:
            lo = mid
        else:
            hi = mid
    return r1, r2, 0.5 * (lo + hi)


def venn2_overlap(ax, overlap: Dict[str, float],
                  colors=('#2b7bba', '#3aa858'), shared_color='#ddcc00',
                  normalize_to: float = 1.0, fontsize: int = 12,
                  title: Optional[str] = None, outline: str = 'black',
                  label_colors=('white', 'white')) -> None:
    """Draw one area-proportional two-set venn onto `ax`
    (plot_overlap_venn, utils/evaluation.py:139-184)."""
    import matplotlib.patches as mpatches
    a_only = float(overlap['Baseline only'])
    shared = float(overlap['Shared'])
    b_only = float(overlap['Predicted only'])
    total = max(a_only + shared + b_only, 1e-9)
    scale = normalize_to / total
    r1, r2, d = _venn2_layout(a_only * scale, shared * scale, b_only * scale)
    x1, x2 = -d / 2, d / 2
    for (x, r, c) in ((x1, r1, colors[0]), (x2, r2, colors[1])):
        ax.add_patch(mpatches.Circle((x, 0), r, facecolor=c, alpha=0.9,
                                     edgecolor='none'))
        if outline:
            ax.add_patch(mpatches.Circle((x, 0), r, facecolor='none',
                                         edgecolor=outline, linewidth=1))
    if shared > 0:
        # shade the lens by clipping one circle against the other
        lens = mpatches.Circle((x1, 0), r1, facecolor=shared_color,
                               edgecolor='none')
        ax.add_patch(lens)
        lens.set_clip_path(mpatches.Circle((x2, 0), r2,
                                           transform=ax.transData))
    def fmt(v: float) -> str:
        # per-value: a mean overlap like (1.5, 0.5, 1.0) must not render
        # as integers just because the panel's total happens to be whole
        return str(int(v)) if v == float(int(v)) else f'{v:.1f}'
    ax.text(x1 - r1 * 0.45, 0, fmt(a_only), ha='center', va='center',
            fontsize=fontsize, color=label_colors[0])
    ax.text(x2 + r2 * 0.45, 0, fmt(b_only), ha='center', va='center',
            fontsize=fontsize, color=label_colors[1])
    if shared > 0:
        mid = 0.5 * (x1 + np.sqrt(max(r1 * r1 - 0, 0))
                     + x2 - np.sqrt(max(r2 * r2 - 0, 0)))
        ax.text(mid, 0, fmt(shared), ha='center', va='center',
                fontsize=fontsize)
    lim = max(r1, r2) * 1.15 + d / 2
    ax.set_xlim(-lim, lim)
    ax.set_ylim(-max(r1, r2) * 1.25, max(r1, r2) * 1.25)
    ax.set_aspect('equal')
    ax.axis('off')
    if title:
        ax.set_title(title, fontsize=fontsize, pad=0)


def plot_overlap(rows: Sequence[Dict], path: str,
                 colors=('#2b7bba', '#3aa858')) -> None:
    """Mean-overlap venn stacked over a per-column boxplot
    (plot_overlap + plot_overlap_boxplot, utils/evaluation.py:113-135)."""
    plt = _plt()
    fig, axes = plt.subplots(2, 1, figsize=(2.8, 4))
    mean = {c: float(np.mean([r[c] for r in rows])) for c in OVERLAP_COLUMNS}
    venn2_overlap(axes[0], mean, colors=colors)
    data = [[r[c] for r in rows] for c in OVERLAP_COLUMNS]
    box = axes[1].boxplot(data, patch_artist=True, widths=0.8)
    for patch, c in zip(box['boxes'], (colors[0], '#ffdd00', colors[1])):
        patch.set_facecolor(c)
    axes[1].set_xticklabels([c.replace(' ', '\n') for c in OVERLAP_COLUMNS],
                            fontsize=8)
    axes[1].set_ylabel('Mutations')
    axes[1].set_ylim(0, None)
    fig.tight_layout(pad=0.3)
    fig.savefig(path, dpi=150, bbox_inches='tight')
    plt.close(fig)


def plot_overlap_venns(rows: Sequence[Dict], path: str, ncols: int = 5,
                       colors=('#2b7bba', '#3aa858'), plot_mean: bool = True,
                       fontsize: int = 10) -> None:
    """Grid of per-antibody venns, sized relative to the largest total,
    optionally with a bold mean panel (plot_overlap_venns,
    utils/evaluation.py:186-215)."""
    plt = _plt()
    n = len(rows) + (1 if plot_mean else 0)
    nrows = (n + ncols - 1) // ncols
    fig, axes = plt.subplots(nrows, ncols,
                             figsize=(1.4 * ncols, 1.5 * nrows))
    axes = np.atleast_1d(axes).reshape(-1)
    for ax in axes:
        ax.set_visible(False)
    max_total = max(sum(r[c] for c in OVERLAP_COLUMNS) for r in rows)
    panels = list(rows)
    if plot_mean:
        mean = {c: float(np.mean([r[c] for r in rows]))
                for c in OVERLAP_COLUMNS}
        mean['name'] = 'Mean'
        panels.append(mean)
    for row, ax in zip(panels, axes):
        ax.set_visible(True)
        total = sum(row[c] for c in OVERLAP_COLUMNS)
        venn2_overlap(ax, row, colors=colors, fontsize=fontsize,
                      normalize_to=1.1 * total / max(max_total, 1e-9),
                      title=str(row.get('name', '')))
    fig.tight_layout(w_pad=0, h_pad=1)
    fig.savefig(path, dpi=150, bbox_inches='tight')
    plt.close(fig)


# ---------------------------------------------------------------------------
# OASis prevalence curves (utils/evaluation.py:218-315)
# ---------------------------------------------------------------------------

OASIS_THRESHOLDS = {'loose': '1%', 'relaxed': '10%', 'medium': '50%',
                    'strict': '90%'}


def load_oasis_curves(path: str):
    """Per-antibody OASis identity curves as a DataFrame indexed by antibody
    with '%'-named prevalence-threshold columns. Reads the BioPhi report's
    'OASis Curves' sheet (xlsx) or a CSV export of it."""
    import pandas as pd
    if path.endswith('.csv'):
        return pd.read_csv(path, index_col=0)
    return pd.read_excel(path, sheet_name='OASis Curves', index_col=0)


def plot_oasis_curves(curves, path: str, groupby: Optional[str] = None,
                      colors: Optional[Dict[str, str]] = None,
                      thresholds: bool = True, fill_alpha: float = 0.1,
                      markers: str = 'osx+vD<>^', ylim=(0, 1)) -> None:
    """OASis identity vs prevalence threshold, one line per group with IQR
    bands (plot_oasis_curves, utils/evaluation.py:226-284)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(6.5, 4.5))
    _draw_oasis_curves(ax, curves, groupby=groupby, colors=colors,
                       thresholds=thresholds, fill_alpha=fill_alpha,
                       markers=markers, ylim=ylim)
    ax.legend(loc='lower center', ncol=4, bbox_to_anchor=(0.5, 1),
              frameon=False, columnspacing=1, handletextpad=0.5)
    fig.savefig(path, dpi=150, bbox_inches='tight')
    plt.close(fig)


def _draw_oasis_curves(ax, curves, groupby: Optional[str] = None,
                       colors: Optional[Dict[str, str]] = None,
                       thresholds: bool = True, fill_alpha: float = 0.1,
                       markers: str = 'osx+vD<>^', ylim=(0, 1)) -> None:
    """Draw the curves panel onto ``ax`` (shared by the standalone figure
    and the combined curve+barplot panel)."""
    import matplotlib.ticker as ticker
    columns = [c for c in curves.columns if '%' in c and c != '0%']
    if groupby is not None:
        grouped = curves.groupby(groupby)
        mean = grouped.mean(numeric_only=True)[columns]
        low = grouped.quantile(0.25, numeric_only=True)[columns]
        high = grouped.quantile(0.75, numeric_only=True)[columns]
    else:
        mean, low, high = curves[columns], None, None
    if colors is None:
        colors = {g: None for g in mean.index}
    x = np.arange(len(columns))
    xticks = [0] + list(range(9, len(columns), 10))
    for i, (group, color) in enumerate(colors.items()):
        y = mean.loc[group].to_numpy(dtype=float)
        ax.plot(x, y, color=color, label=str(group), lw=1.5, zorder=1000)
        ax.scatter(xticks, y[xticks], color=color, s=30,
                   marker=markers[i % len(markers)], zorder=2000)
        if low is not None:
            ax.fill_between(x, low.loc[group].to_numpy(dtype=float),
                            high.loc[group].to_numpy(dtype=float) + 1e-7,
                            alpha=fill_alpha, color=color)
    ax.set_xlabel('Human subject prevalence threshold')
    ax.set_xticks(xticks)
    ax.set_xticklabels([columns[t] + ' ' for t in xticks])
    ax.set_ylabel('OASis identity')
    ax.set_yticks(np.arange(0, 1.01, 0.1))
    ax.yaxis.set_major_formatter(
        ticker.FuncFormatter(lambda y, _: '{:.0%}'.format(y)))
    ax.set_ylim(ylim)
    ax.set_xlim(xticks[0] - 2, xticks[-1] + 2)
    if thresholds:
        for label, col in OASIS_THRESHOLDS.items():
            if col not in columns:
                continue
            tx = columns.index(col)
            ax.axvline(tx, color='#777777', lw=1)
            dx, ha = (-0.6, 'right') if label == 'strict' else (0.6, 'left')
            ax.text(tx + dx, ylim[0] + 0.03, label, rotation=90,
                    color='#111111', ha=ha)


def plot_oasis_curve_and_barplots(curves, groupby: str, path: str,
                                  colors: Optional[Dict[str, str]] = None
                                  ) -> None:
    """Curves panel plus one identity boxplot per named threshold
    (plot_oasis_curve_and_barplots, utils/evaluation.py:287-315)."""
    plt = _plt()
    import matplotlib.ticker as ticker
    groups = list(colors.keys()) if colors else sorted(
        curves[groupby].unique())
    ncol = 1 + len(OASIS_THRESHOLDS)
    fig, axes = plt.subplots(
        1, ncol, figsize=(13.5, 4.5),
        gridspec_kw=dict(width_ratios=[3.5] + [1] * len(OASIS_THRESHOLDS)))
    _draw_oasis_curves(axes[0], curves, groupby=groupby, colors=colors)
    axes[0].legend(loc='upper center', ncol=3, bbox_to_anchor=(0.5, -0.15),
                   frameon=False)
    for i, (label, col) in enumerate(OASIS_THRESHOLDS.items()):
        ax = axes[i + 1]
        data = [curves.loc[curves[groupby] == g, col].to_numpy(dtype=float)
                for g in groups]
        box = ax.boxplot(data, patch_artist=True, widths=0.76)
        if colors:
            for patch, g in zip(box['boxes'], groups):
                patch.set_facecolor(colors[g])
        ax.set_ylim(0, 1)
        ax.set_yticks(np.arange(0, 1.01, 0.1))
        ax.yaxis.set_major_formatter(
            ticker.FuncFormatter(lambda y, _: '{:.0%}'.format(y)))
        ax.set_ylabel(f'OASis identity ({label})')
        ax.set_xticklabels([str(g) for g in groups], rotation=90)
    fig.tight_layout()
    fig.savefig(path, dpi=150, bbox_inches='tight')
    plt.close(fig)
