"""Network configurations the port runs."""
