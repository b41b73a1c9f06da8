"""Model zoo of the port: the decoder-only LM transformer, the GNN zoo and
Wide & Deep."""
