"""The general parts of the benchmark: the cell's files, the synthesized
inputs, the trace's reduction and the table of peaks."""
