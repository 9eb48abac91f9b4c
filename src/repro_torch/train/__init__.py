"""Training for the PyTorch port: the optimizers of ``repro/train/optimizer.py``
(AdamW with the warmup-cosine schedule and global-norm clipping, SGD with
momentum) and the Darknet CNN train step of ``repro/train/train_step.py``.
The LM train step comes with the LM slice."""
