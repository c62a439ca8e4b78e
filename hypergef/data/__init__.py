from hypergef.data.synthetic import random_hypergraph, powerlaw_hypergraph

__all__ = ["random_hypergraph", "powerlaw_hypergraph"]
