"""Device stages of the port: symbol maps, suffix arrays, match tables,
the Huffman bundle, the splitter, the block planner, and the wrappers of
the walk, DP and chain kernels. Nothing here imports at package load;
each module is imported where it is used."""
