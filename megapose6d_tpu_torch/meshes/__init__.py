"""Mesh IO and the padded mesh database."""
