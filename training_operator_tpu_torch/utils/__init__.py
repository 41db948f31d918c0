"""Cross-cutting utilities: metrics, structured logging, naming."""
