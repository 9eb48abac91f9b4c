"""Runnable examples of the port, each the twin of a script of the JAX
package's ``examples/``: ``python -m repro_torch.examples.<name>``
(quickstart, cnn_inference, serve_cnn, serve_lm, train_lm).  They run on
the card by default; ``--device cpu`` runs them on the CPU."""
