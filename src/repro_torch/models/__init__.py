"""Model zoo of the port: the decoder-only LM transformer."""
