"""Entry points of the port: ``serve`` (LM serving demo)."""
