"""Training for the PyTorch port: the optimizers of
``repro/train/optimizer.py`` (AdamW with the warmup-cosine schedule and
global-norm clipping, SGD with momentum), error-feedback gradient
compression, and the LM and Darknet CNN train steps of
``repro/train/train_step.py``."""
