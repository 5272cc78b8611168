"""The whole-run transient: host tables, kernel wrapper, plain version."""
