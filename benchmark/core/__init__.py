"""The harness: manifest, set-up, window, trace, checks and the result."""
