"""Cross-rank failure handling: the abort ("poison") protocol's types."""
