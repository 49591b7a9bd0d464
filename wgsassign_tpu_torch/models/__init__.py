"""Analyses on a device-resident cohort."""
