"""Estimation experiment configs of the paper (section 5)."""
