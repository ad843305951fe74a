"""Posit formats, the posit codec and the rounded arithmetic context."""
