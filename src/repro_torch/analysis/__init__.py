"""Analysis of the port's steps without running them (PyTorch port of
``repro/analysis``): the three-term roofline of `roofline.py` on the H100's
own figures."""
