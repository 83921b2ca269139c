"""Launchers: the serve CLI."""
