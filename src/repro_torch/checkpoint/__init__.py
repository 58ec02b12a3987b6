"""Weights in and out of the port (so far: conversion from and to the
JAX package's numpy-leaved params, the paper LSTM's and the model
zoo's)."""
