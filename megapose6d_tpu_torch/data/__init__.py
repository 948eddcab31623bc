"""Observation and collection types."""
