"""Ops of the port: each kernel wrapper sits beside its plain version."""
