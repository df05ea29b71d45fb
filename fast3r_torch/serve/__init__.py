"""Headless serving output: merged point clouds and PLY export."""
