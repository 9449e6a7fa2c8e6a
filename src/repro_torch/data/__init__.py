"""Synthetic data generators and the streaming stats pipeline."""
