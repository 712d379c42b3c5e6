"""Quantized weight residency and quantized checkpoint ingestion."""
