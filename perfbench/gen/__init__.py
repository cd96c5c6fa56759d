"""Frozen input generators of the benchmark (numpy only): the graph and its
partition.  Each names the program code it was copied from; later changes
to the program do not move them."""
