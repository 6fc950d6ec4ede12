"""Entry points of the port's token models (serving)."""
