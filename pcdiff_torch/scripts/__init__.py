"""Command-line tools of the port that are not part of its library (profiling)."""
