"""Dtype policy and device convention (``types``)."""
