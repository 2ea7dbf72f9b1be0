# coding=utf-8
"""Logging and metric writing, the file cache, seeding and dtype helpers."""
