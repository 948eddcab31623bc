"""Evaluation: BOP CSV bridge, meters, VSD, prediction/evaluation runners."""
