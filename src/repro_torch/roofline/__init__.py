"""Roofline terms of the dry run against an H100, and their tables."""
