"""Plotting utilities (reference: python-package/lightgbm/plotting.py).

Port of lightgbm_tpu/plotting.py over the port's Booster: feature
importance, metric curves, split-value histograms and tree digraphs, all
on the host. matplotlib and graphviz are imported inside the functions,
so the package imports without them."""
from __future__ import annotations

import numpy as np

from .basic import Booster
from .sklearn import LGBMModel


def _to_booster(obj) -> Booster:
    if isinstance(obj, LGBMModel):
        return obj.booster_
    if isinstance(obj, Booster):
        return obj
    raise TypeError("booster must be Booster or LGBMModel")


def plot_importance(booster, ax=None, height=0.2, xlim=None, ylim=None,
                    title="Feature importance", xlabel="Feature importance",
                    ylabel="Features", importance_type="split",
                    max_num_features=None, ignore_zero=True, figsize=None,
                    dpi=None, grid=True, precision=3, **kwargs):
    import matplotlib.pyplot as plt
    booster = _to_booster(booster)
    importance = booster.feature_importance(importance_type)
    names = booster.feature_name()
    tuples = sorted(zip(names, importance), key=lambda x: x[1])
    if ignore_zero:
        tuples = [t for t in tuples if t[1] > 0]
    if max_num_features is not None and max_num_features > 0:
        tuples = tuples[-max_num_features:]
    if not tuples:
        raise ValueError("Cannot plot trees with zero importance")
    labels, values = zip(*tuples)
    if ax is None:
        _, ax = plt.subplots(1, 1, figsize=figsize, dpi=dpi)
    ylocs = np.arange(len(values))
    ax.barh(ylocs, values, align="center", height=height, **kwargs)
    for x, y in zip(values, ylocs):
        ax.text(x + 1, y,
                f"{x:.{precision}f}" if importance_type == "gain" else str(x),
                va="center")
    ax.set_yticks(ylocs)
    ax.set_yticklabels(labels)
    if xlim is not None:
        ax.set_xlim(xlim)
    if ylim is not None:
        ax.set_ylim(ylim)
    else:
        ax.set_ylim(-1, len(values))
    if title:
        ax.set_title(title)
    if xlabel:
        ax.set_xlabel(xlabel)
    if ylabel:
        ax.set_ylabel(ylabel)
    ax.grid(grid)
    return ax


def plot_metric(booster, metric=None, dataset_names=None, ax=None, xlim=None,
                ylim=None, title="Metric during training", xlabel="Iterations",
                ylabel="auto", figsize=None, dpi=None, grid=True):
    import matplotlib.pyplot as plt
    if isinstance(booster, LGBMModel):
        eval_results = booster.evals_result_
    elif isinstance(booster, dict):
        eval_results = booster
    else:
        raise TypeError("booster must be dict or LGBMModel")
    if not eval_results:
        raise ValueError("eval results cannot be empty")
    if ax is None:
        _, ax = plt.subplots(1, 1, figsize=figsize, dpi=dpi)
    names = dataset_names or list(eval_results.keys())
    msuite = eval_results[names[0]]
    if metric is None:
        metric = list(msuite.keys())[0]
    for name in names:
        if metric in eval_results.get(name, {}):
            results = eval_results[name][metric]
            ax.plot(range(len(results)), results, label=name)
    ax.legend(loc="best")
    if title:
        ax.set_title(title)
    ax.set_xlabel(xlabel)
    ax.set_ylabel(metric if ylabel == "auto" else ylabel)
    ax.grid(grid)
    return ax


def plot_split_value_histogram(booster, feature, bins=None, ax=None,
                               width_coef=0.8, xlim=None, ylim=None,
                               title="Split value histogram for feature with @index/name@ @feature@",
                               xlabel="Feature split value", ylabel="Count",
                               figsize=None, dpi=None, grid=True, **kwargs):
    import matplotlib.pyplot as plt
    booster = _to_booster(booster)
    if isinstance(feature, str):
        feature = booster.feature_name().index(feature)
    values = []
    for tree in booster._gbdt.models:
        for node in range(tree.num_leaves - 1):
            if tree.split_feature[node] == feature and not tree._is_categorical(node):
                values.append(float(tree.threshold[node]))
    if not values:
        raise ValueError("Feature was not used in splitting of trees")
    if ax is None:
        _, ax = plt.subplots(1, 1, figsize=figsize, dpi=dpi)
    hist, bin_edges = np.histogram(values, bins=bins or "auto")
    centers = (bin_edges[:-1] + bin_edges[1:]) / 2
    ax.bar(centers, hist, align="center",
           width=width_coef * (bin_edges[1] - bin_edges[0]), **kwargs)
    if title:
        title = title.replace("@feature@", str(feature)).replace(
            "@index/name@", "index")
        ax.set_title(title)
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    ax.grid(grid)
    return ax


def create_tree_digraph(booster, tree_index=0, show_info=None, precision=3,
                        **kwargs):
    import graphviz
    booster = _to_booster(booster)
    tree = booster._gbdt.models[tree_index]
    names = booster.feature_name()
    graph = graphviz.Digraph(**kwargs)
    show_info = show_info or []

    def add(node, parent=None, decision=None):
        if node >= 0:
            name = f"split{node}"
            feat = names[tree.split_feature[node]] \
                if tree.split_feature[node] < len(names) else str(tree.split_feature[node])
            label = f"{feat}"
            if tree._is_categorical(node):
                label += " = [cats]"
            else:
                label += f" <= {tree.threshold[node]:.{precision}f}"
            if "split_gain" in show_info:
                label += f"\\ngain: {tree.split_gain[node]:.{precision}f}"
            if "internal_count" in show_info:
                label += f"\\ncount: {tree.internal_count[node]}"
            graph.node(name, label=label)
            add(tree.left_child[node], name, "yes")
            add(tree.right_child[node], name, "no")
        else:
            leaf = ~node
            name = f"leaf{leaf}"
            label = f"leaf {leaf}: {tree.leaf_value[leaf]:.{precision}f}"
            if "leaf_count" in show_info:
                label += f"\\ncount: {tree.leaf_count[leaf]}"
            graph.node(name, label=label)
        if parent is not None:
            graph.edge(parent, name, decision)

    add(0)
    return graph


def plot_tree(booster, ax=None, tree_index=0, figsize=None, dpi=None,
              show_info=None, precision=3, **kwargs):
    import matplotlib.image as mpimg
    import matplotlib.pyplot as plt
    if ax is None:
        _, ax = plt.subplots(1, 1, figsize=figsize, dpi=dpi)
    graph = create_tree_digraph(booster, tree_index, show_info, precision)
    import io
    s = io.BytesIO(graph.pipe(format="png"))
    img = mpimg.imread(s)
    ax.imshow(img)
    ax.axis("off")
    return ax
