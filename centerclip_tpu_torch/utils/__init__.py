# coding=utf-8
"""Logging and metric writing."""
