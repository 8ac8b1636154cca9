"""The plain reference and the check of the served tokens against it."""
