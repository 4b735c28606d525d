"""Custom-FP formats, gate-level circuits, netlist codegen, codecs and
the bitslice carrier."""
