"""Mean seconds of the window's screened-Poisson reconstructions (a span
around poisson.solve that ends in a device synchronize)."""


def read(rec):
    s = rec.get("solves")
    return sum(s) / len(s) if s else None
