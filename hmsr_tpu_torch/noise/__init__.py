from .fast_monte_carlo import (fit_alpha_beta, get_non_linearity_bound,
                               load_noise_curves, monte_carlo_curves, round_iso,
                               run_fast_MC)

__all__ = ["run_fast_MC", "get_non_linearity_bound", "monte_carlo_curves",
           "load_noise_curves", "round_iso", "fit_alpha_beta"]
