"""Device operations: k-mer hashing, bottom-s folds, pairwise kernels."""
