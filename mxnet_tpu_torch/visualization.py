"""Network visualization.

Counterpart of ``mxnet_tpu/visualization.py`` (parity: reference
``python/mxnet/visualization.py``): ``print_summary`` (a table of the
layers with their output shapes and parameter counts, printed as the JAX
package prints it) and ``plot_network`` (a graphviz ``Digraph``; raises
naming the package where ``graphviz`` is not installed).
"""
from __future__ import annotations

import numpy as np

from .base import MXNetError

__all__ = ["print_summary", "plot_network"]


def print_summary(symbol, shape=None, line_length=120, positions=None):
    """(parity: visualization.print_summary)"""
    import json
    if positions is None:
        positions = [0.44, 0.64, 0.74, 1.0]
    conf = json.loads(symbol.tojson())
    nodes = conf["nodes"]
    show_shape = shape is not None
    shape_dict = {}
    if show_shape:
        interals = symbol.get_internals()
        _, out_shapes, _ = interals.infer_shape_partial(**shape)
        shape_dict = dict(zip(interals.list_outputs(), out_shapes))
    positions = [int(line_length * p) for p in positions]
    to_display = ["Layer (type)", "Output Shape", "Param #",
                  "Previous Layer"]

    def print_row(fields, positions):
        line = ""
        for i, field in enumerate(fields):
            line += str(field)
            line = line[:positions[i]]
            line += " " * (positions[i] - len(line))
        print(line)

    print("_" * line_length)
    print_row(to_display, positions)
    print("=" * line_length)
    total_params = 0
    counted = set()
    for node in nodes:
        op = node["op"]
        name = node["name"]
        if op == "null" and not name.endswith(("weight", "bias", "gamma",
                                               "beta")):
            cls_name = "%s (%s)" % (name, "input")
            out_shape = shape_dict.get(name + "_output",
                                       shape_dict.get(name, ""))
            print_row([cls_name, str(out_shape or ""), 0, ""], positions)
            continue
        if op == "null":
            continue
        out_name = name + "_output"
        out_shape = shape_dict.get(out_name, "")
        # param count: this node's learnable-looking null inputs that no
        # earlier node counted. The JAX package counts an input only when
        # its name starts with the node's, which counts nothing for the
        # shared weights of an unrolled cell (``c_i2h_weight`` feeds
        # ``c_t0_i2h``, ``c_t1_i2h``, ...); conventionally named graphs
        # print the same either way.
        params = 0
        for in_idx, *_ in node["inputs"]:
            in_node = nodes[in_idx]
            if in_node["op"] == "null" and in_idx not in counted \
                    and in_node["name"].endswith(("weight", "bias",
                                                  "gamma", "beta",
                                                  "parameters")):
                counted.add(in_idx)
                s = shape_dict.get(in_node["name"], None)
                if s:
                    params += int(np.prod(s))
        total_params += params
        first_conn = ",".join(nodes[i]["name"]
                              for i, *_ in node["inputs"]
                              if nodes[i]["op"] != "null")
        print_row(["%s (%s)" % (name, op), str(out_shape or ""), params,
                   first_conn], positions)
    print("=" * line_length)
    print("Total params: %d" % total_params)
    print("_" * line_length)
    return total_params


def plot_network(symbol, title="plot", save_format="pdf", shape=None,
                 node_attrs=None, hide_weights=True):
    """(parity: visualization.plot_network — requires graphviz)"""
    try:
        from graphviz import Digraph
    except ImportError:
        raise MXNetError("plot_network requires the graphviz package")
    import json
    conf = json.loads(symbol.tojson())
    nodes = conf["nodes"]
    dot = Digraph(name=title)
    hidden = set()
    for i, node in enumerate(nodes):
        name = node["name"]
        if node["op"] == "null":
            if hide_weights and name.endswith(("weight", "bias", "gamma",
                                               "beta", "moving_mean",
                                               "moving_var")):
                hidden.add(i)
                continue
            dot.node(name=name, label=name, shape="oval")
        else:
            dot.node(name=name, label="%s\n%s" % (name, node["op"]),
                     shape="box")
    for i, node in enumerate(nodes):
        if node["op"] == "null":
            continue
        for in_idx, *_ in node["inputs"]:
            if in_idx in hidden:
                continue
            dot.edge(nodes[in_idx]["name"], node["name"])
    return dot
