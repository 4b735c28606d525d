"""Entry points of the port: ``serve`` (LM serving demo) and ``train``
(the training loop)."""
