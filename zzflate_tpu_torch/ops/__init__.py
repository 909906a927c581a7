"""Device ops of the port: matcher, kernels, bit packing, histograms, host Huffman."""
