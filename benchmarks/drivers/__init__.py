"""Drivers, one per kind of traffic mix."""
