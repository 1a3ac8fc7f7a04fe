"""Logical-axis sharding rules, dry-run spec builders and activation specs of the port."""
