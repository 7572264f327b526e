"""The fused adversarial train step of the port."""
