"""Adversarial, feature-matching, time-domain and encoder losses of the port."""
