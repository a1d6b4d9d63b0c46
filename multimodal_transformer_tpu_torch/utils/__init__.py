"""Initialisers and parameter-tree helpers of the port."""
