"""The LM of the port: dense GQA transformer blocks on the compute engine."""
