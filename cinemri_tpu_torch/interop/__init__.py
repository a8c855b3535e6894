"""Weight movers between the JAX package's parameter trees and the port."""
