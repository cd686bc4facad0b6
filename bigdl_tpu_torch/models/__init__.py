"""Model zoo of the port (so far the decoder-only TransformerLM)."""
