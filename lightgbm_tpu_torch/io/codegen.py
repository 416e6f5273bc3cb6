"""Model -> standalone C++ if-else predictor source.

Port of lightgbm_tpu/io/codegen.py (reference: the convert_model task,
src/boosting/gbdt_model_text.cpp:128 ModelToIfElse, src/io/tree.cpp:361
Tree::NumericalDecisionIfElse): one PredictTreeN function per tree and a
Predict() entry that sums them per class, compilable with g++ alone. The
source is the JAX package's for the same model, character for character.
"""
from __future__ import annotations

from typing import List


def _node_code(tree, node: int, indent: int) -> str:
    pad = "  " * indent
    if node < 0:
        leaf = ~node
        return f"{pad}return {float(tree.leaf_value[leaf])!r};\n"
    f = int(tree.split_feature[node])
    out = ""
    if tree._is_categorical(node):
        cats = tree._cats_for_node(node)
        cond = " || ".join(f"ival == {c}" for c in cats) or "false"
        out += f"{pad}{{ int ival = (int)arr[{f}];\n"
        out += f"{pad}if ({cond}) {{\n"
    else:
        mt = tree._missing_type(node)
        thr = float(tree.threshold[node])
        dl = tree._default_left(node)
        fv = f"arr[{f}]"
        if mt == 2:  # NaN
            miss = f"std::isnan({fv})"
        elif mt == 1:  # Zero
            miss = f"(std::isnan({fv}) || std::fabs({fv}) <= 1e-35)"
        else:
            miss = "false"
        if dl:
            cond = f"{miss} || (!std::isnan({fv}) && {fv} <= {thr!r})"
        else:
            cond = (f"!{miss} && (std::isnan({fv}) ? 0.0 <= {thr!r} : "
                    f"{fv} <= {thr!r})")
        out += f"{pad}if ({cond}) {{\n"
    out += _node_code(tree, tree.left_child[node], indent + 1)
    out += f"{pad}}} else {{\n"
    out += _node_code(tree, tree.right_child[node], indent + 1)
    out += f"{pad}}}\n"
    if tree._is_categorical(node):
        out += f"{pad}}}\n"
    return out


def model_to_ifelse(gbdt) -> str:
    """C++ source of `gbdt`'s trees: ``Predict(const double* arr, double*
    out)`` writes the raw score of each class."""
    lines: List[str] = [
        "#include <cmath>",
        "#include <cstring>",
        "",
        "namespace lightgbm_tpu_model {",
        "",
    ]
    for i, tree in enumerate(gbdt.models):
        lines.append(f"double PredictTree{i}(const double* arr) {{")
        if tree.num_leaves <= 1:
            lines.append(f"  return {float(tree.leaf_value[0])!r};")
        else:
            lines.append(_node_code(tree, 0, 1).rstrip())
        lines.append("}")
        lines.append("")
    k = gbdt.num_tree_per_iteration
    lines.append(
        f"void Predict(const double* arr, double* out) {{  // {k} class(es)")
    for c in range(k):
        terms = " + ".join(
            f"PredictTree{i}(arr)" for i in range(len(gbdt.models))
            if i % k == c) or "0.0"
        lines.append(f"  out[{c}] = {terms};")
    lines.append("}")
    lines.append("")
    lines.append("}  // namespace lightgbm_tpu_model")
    return "\n".join(lines) + "\n"
