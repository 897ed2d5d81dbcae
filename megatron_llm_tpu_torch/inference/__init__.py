"""Whole-batch generation and the HTTP server."""
