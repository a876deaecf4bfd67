"""Device ms a unit of cuBLAS products (kernels named as GEMMs, or launched
by a matrix-product operator): the 1x1 mixes, MLPs, embeddings and heads."""


def read(r, name):
    s = r.trace.by_category().get("cublas", 0.0)
    return 1e3 * s / r.units if s else None
