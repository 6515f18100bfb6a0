// Parity: ref src/java/.../InferenceException.java role.
package torch.client;

public class InferenceException extends Exception {
  private final int statusCode;

  public InferenceException(String message) {
    this(message, 0);
  }

  public InferenceException(String message, int statusCode) {
    super(message);
    this.statusCode = statusCode;
  }

  public int statusCode() { return statusCode; }
}
