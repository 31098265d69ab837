"""Retry and health helpers of the service."""
