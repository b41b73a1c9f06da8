"""Serving stack of the port: slot decode engine, retrieval cache, fused RAG engine."""
