"""Metric helpers, run logging and step timing of the port's trainer."""
