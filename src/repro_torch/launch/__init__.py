"""Launchers: the serve and train CLIs, and the training step."""
