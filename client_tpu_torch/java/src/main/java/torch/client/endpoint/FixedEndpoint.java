// Single fixed endpoint. Parity: ref src/java/.../endpoint/FixedEndpoint.java.
package torch.client.endpoint;

public class FixedEndpoint extends AbstractEndpoint {
  private final String url;

  public FixedEndpoint(String url) {
    this.url = url.contains("://") ? url : "http://" + url;
  }

  @Override
  public String next() {
    return url;
  }

  @Override
  public int size() {
    return 1;
  }
}
